#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sparkdq4ml_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. device: a CUDA device must be present; prints its name and power limit;
2. build: starts the CPU float64 references of phases 7-8, 11 and 12,
   one spawned process each at 3 intra-op threads, and compiles the CUDA
   kernels from the sources in the checkout (the three ports of the TPU
   kernels and the port's own segment sums), one nvcc each, all started
   together beside them; waits for the references (their results come back
   through files in a temporary directory the script removes), so that
   no card phase shares the host with them; then one wrapper call of each
   Gramian under torch.profiler at the app's, the tour's and the full
   table's shapes, for the number of kernels it launches (first, while no
   other profiler session has run in the process);
3. parity: each kernel against its plain PyTorch version on the card, in
   float32 and float64, at the listed sizes, including NaNs, an int32
   guest column, n = 0, boolean and float weights for the masked Gramian,
   the Gramians' tile edges (D = 5, 128, 256 and a ragged n at D = 130),
   two runs of each Gramian that must agree bit for bit, and each Gramian
   equal to its transpose bit for bit; the two segment sums (dense slots,
   sorted segments) against their plain version in float64 (index_add_;
   sum at one slot) and bit-identical over two runs, at ragged edges and
   at the 10^7-row table's shapes (9,611,537 clean rows onto 39 guest
   slots, onto 20,556 price groups, onto 39 long segments; the 10^7 slots
   of the global sums onto one slot, three stacked columns and one, with
   an all-zero id column and without ids, the whole-table form the global
   sums take; the sorted kernel's stage and block edges, one segment over
   9,611,537 rows, runs of one row, ids outside the table, sparse ids,
   five and seven columns, views off the 16-byte grid); each call of
   either, in either type, one launch, one device kernel and at most one
   memset (the nodes of a CUDA graph captured from the call); both kernels
   on two streams at once, bit for bit against one stream;
4. golden app: the reference application (CSV -> DQ rules -> SQL ->
   VectorAssembler -> Lasso fit -> predict(40)) on the three datasets
   through ``TorchSession`` (each read by the native CSV engine), in
   float32, against the row counts and fit numbers of SURVEY.md section
   2.3;
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
   events (median of 25 runs after warm-up; for the segment sums also the
   device time of single calls of the kernel and of the library call from
   a torch.profiler trace, and the wrapper's host path, the first less the
   second), the app phase (median of
   5 runs; the counts come from the first), the model-selection paths
   (three runs each, the counted one first), and one more run of the app
   phase and of each model-selection path under torch.profiler for the
   device's idle share (the kernel tables go to
   chiprun_out/<path>_profile.txt);
7. SQL core (its CPU float64 reference, shared with phase 8, from phase
   2): the whole of examples/sql_tour.py (GROUP BY with HAVING and
   ORDER BY, the sorted-program groupings, sort, distinct, joins, window
   functions, arithmetic, a derived table, explode, the CTE with a scalar
   subquery, IN (subquery) against LEFT SEMI, temp-view DDL) on
   dataset-full against SQL_TOUR_GOLDEN, then six steps on the 10^7-row
   table cleaned by the fused DQ kernel (the rows dq_clean keeps), in
   float32, with the launch counts reset just before and read just after
   (dq_rules must launch once, both segment sums at least once), each
   step's host-clock time (the window step one run, the others three),
   one run under torch.profiler (its kernel table written beside
   phase 6's), every result held against the CPU float64 run of the same
   code, steps 1 and 2 bit-identical over two runs and the price >
   avg_price count the same in every join run;
8. the rest of the SQL tour on the same cleaned table (its own dq_rules
   launch and counts): the CTE with a scalar AVG subquery, IN (subquery)
   against LEFT SEMI JOIN, IN/BETWEEN and a CASE band (a string column of
   9.6 M rows), GROUP BY/ORDER BY/join/LIKE/distinct/window on the band,
   CREATE/DROP TEMP VIEW; held to the CPU float64 run (one clean table and
   session shared with phase 7's), steps 1-4 bit-identical over two runs,
   each step's median of 3 (of 2 for steps 2 and 4) and the band's
   dictionary-encoding time;
9. classifiers: the tour's classifier section (examples/ml_pipeline_tour.py:
   LogisticRegression graded by BinaryClassificationEvaluator, then
   LinearSVC and its accuracy) on dataset-full against ML_TOUR_GOLDEN;
   then seven fits on the 10^7-row table cleaned by one dq_rules launch,
   in float32 (binomial Newton on guest > 25 and on price > 102.5,
   binomial FISTA on price > 102.5, multinomial Newton, NaiveBayes and
   OneVsRest on a three-way price band, LinearSVC on price > 102.5), each
   with its launch counts reset just before its first run and read just
   after (masked_gram once per binomial Newton iteration), the median of
   3 host-clock fit times, its evaluation's time, its synchronizing calls
   and one run under torch.profiler, held against the CPU float64 run of
   the same code (the FISTA, LinearSVC, multinomial and OneVsRest fits
   held on the first 10^6 clean rows, on the card as on the CPU; OneVsRest's
   two nearly separable binary fits by their objectives, not their
   iterations and coefficients);
10. ingest and IO: which optional modules (pandas, pyarrow) the machine
   has; examples/io_tour.py on dataset-full through the session on the
   card (CSV, Parquet and JSON round trips, unpivot, applyInPandas,
   mapInPandas, spark.table; a step whose module is missing does not
   run); then the 10^7-row table written as a headerless CSV (guest,
   price at two decimals) to a temporary directory, read by the native
   engine streamed into page-locked buffers and copied to the card, its
   columns bit-identical to phase 5's createDataFrame ones, and driven
   through the app to predict(40) with the launch counts reset just
   before and read just after (dq_rules and packed_gram once each), its
   result equal to phase 5's card result and within 1e-3 of its CPU
   float64 one; the one-shot read, a quoted copy of the first 10^6 rows
   (the per-chunk body), the Python engine on the first 10^5 rows and a
   Parquet round trip, each bit-identical to the streamed read; the
   float64-policy streamed read and the quoted file cut into about 100
   chunks (float32 and float64), each bit-identical to its one-shot read,
   the float64 read also to the columns the file was written from; the
   median of 3 host-clock times of the streamed and one-shot reads, of
   file to predict(40) and of applyInPandas by guest at 10^7 rows, and
   one streamed read under torch.profiler (idle share, copy kinds);
11. a DQ report on the 10^7-row table, raw and cleaned by one dq_rules
   launch (with phase 8's CASE band): the profile (describe, summary,
   corr pearson and spearman, cov, approxQuantile, crosstab), per-guest
   order statistics and moments and the median guest at each of 20,556
   prices, rollup, cube, ROLLUP in SQL and a pivot, the rejected rows by
   set operations (EXCEPT ALL 388,463 rows, INTERSECT ALL 9,611,537, and
   the distinct forms, frame and SQL), correlated EXISTS / NOT EXISTS / IN
   (and EXISTS / NOT EXISTS with an inner price filter, a proper subset)
   against their explicit LEFT SEMI / ANTI joins, sample and randomSplit;
   the CPU float64 run of the profile, per-guest, subtotal and sampling
   steps first, then the card with the launch counts reset just before
   and read just after (dq_rules once, both segment sums at least once),
   each step's median of 3 host-clock times, one run under
   torch.profiler, steps 2-3 bit-identical over two runs, the order
   statistics, the sampling masks and every row of the set-operation and
   correlated steps against numpy, the other results against the CPU
   run;
12. the builtin function library as a DQ standardization pass over the
   10^7-row table cleaned by one dq_rules launch (with phase 8's CASE
   band): the numeric builtins on every clean row, fluent and as
   selectExpr (round, bround, floor, ceil, log1p, sqrt, cbrt, pow, hypot,
   pmod, sign, greatest/least/coalesce/nanvl over a NaN-holed column,
   atan2); dates on every clean row (the fields, last_day, add_months,
   months_between, trunc, datediff, date_format, date_add/date_sub) and
   to_date of 10^6 date strings; the string builtins on the first 10^6
   clean rows; arrays, the higher-order
   functions, posexplode and explode on 10^5 rows; hash, xxhash64, crc32,
   get_json_object and json_tuple on 10^5 rows; rand/randn/ids on every
   slot and a SELECT without FROM; the timestamp family under the float64
   policy (under float32 it must raise). The CPU float32 run first, then
   the card with the launch counts reset just before and read just after
   (dq_rules once), each step's median of 3 host-clock times and one run
   under torch.profiler; every column bit for bit against the CPU float32
   run but the transcendental ones, within 2e-6 of the CPU float64 run on
   the same float32 prices; the hashes against the JAX package's
   (BUILTIN_HASH_GOLDEN); the row counts Σ(guest % 5 + 1), numpy's draws
   and the other identities;
13. the model zoo: (a) the tour's zoo (examples/ml_pipeline_tour.py: 95-124)
   on dataset-full, float32, against ZOO_TOUR_GOLDEN (the JAX package's output)
   and the tour's asserts; (b) on the 10^7-row table cleaned by one dq_rules
   launch, a gamma/log GLM, GBTRegressor(20, depth 3, step 0.2),
   RandomForestClassifier(10 trees, depth 4) on guest > 25,
   DecisionTreeRegressor() (its depth-5 level takes the sorted segment sum),
   KMeans(k=3, seed=7) with the silhouette, GaussianMixture(k=3) and
   BisectingKMeans(k=4), and PIC on a seeded 4,096-node graph of three planted
   communities, each on the card twice (bit-identical) with the launch counts
   reset just before and read just after, one GBT fit under torch.profiler; (c)
   against the float64 run of the same steps on the same rows (the trees and
   the GMM on the card under the float64 policy, the rest on the CPU): GLM
   coefficients within 1e-4 and deviance within 1e-5 with masked_gram
   launched once an IRLS iteration and once more, every tree split whose
   float64 gain leads its runner-up by more than 1e-4 (the nearer ties
   printed), RMSE and accuracy within 1e-4, KMeans sizes exact and centers
   and silhouette within 1e-5, the GMM log-likelihood within 1e-4, PIC's
   partition the CPU run's and the planted one; torch.argmax's first maximum on the card; the segment sums at
   the histogram, k-slot and PIC affinity shapes against their plain version,
   timed.
14. the ML tour's second half: (a) the tour's :125-224 (LinearSVC, FMClassifier
   on the XOR quadrants, IsotonicRegression, AFTSurvivalRegression, FPGrowth,
   Word2Vec's synonyms, the LSH 3-NN, LDA, PIC, PrefixSpan) on dataset-full,
   float32, against TOUR_REST_GOLDEN (the JAX package's output): exact, or
   isotonic's predict(30) within 1e-9, the floats within 1e-4; (b) at the
   sizes users run, each fit twice on the card (bit-identical) with the launch
   counts reset just before and read just after: FMClassifier (400 Adam steps)
   and FMRegressor (200) on 10^7 XOR rows, AFTSurvivalRegression (300) on 10^7
   survival rows, IsotonicRegression guest -> price (isotonic, antitonic,
   weighted by guest % 3 + 1) on the table cleaned by one dq_rules launch,
   FPGrowth on 10^5 baskets, PrefixSpan on 10^4 sessions, Word2Vec (100
   dimensions, batch 4,096) on 10^5 topical Zipf documents with its transform
   and the synonyms of its 20 most frequent words, 10 nearest-neighbor queries
   of BucketedRandomProjectionLSH over the 10^7 XOR points, a 10^4 x 10^4
   similarity join at bucket length 0.05, MinHashLSH on 10^4 binary rows, LDA
   (k = 10) by EM and online on 10^5 documents of 1,024 terms, each with its
   log perplexity and top terms; one Word2Vec fit under torch.profiler; (c)
   against the float64 run of FM, AFT, Word2Vec and LDA on the card with the
   float32 run's draws, and independent numpy code for the rest (isotonic by
   argsort, reduceat and PAVA, brute-force itemsets and patterns, LSH hashes,
   neighbors and join, MinHash, Word2Vec's negatives by numpy's threefry); the
   segment sums at Word2Vec's and isotonic's shapes against their plain
   version, timed.
15. the feature layer and spark.ml.stat: on the 10^7-row table cleaned by
   one dq_rules launch, with a string tier (the price band), a price with
   every seventh slot NaN and the labels of phase 9, one pipeline as a
   user prepares data for a fit: StringIndexer and OneHotEncoder on the
   tier, Imputer (median), Bucketizer on guest, QuantileDiscretizer (10
   buckets) on the imputed price, VectorAssembler, PolynomialExpansion
   (degree 2), StandardScaler (mean and std), PCA (k = 3), Correlation
   (pearson, spearman) and Summarizer over the scaled vector, ChiSquareTest
   of the bucket columns against the band, UnivariateFeatureSelector and
   VarianceThresholdSelector on the scaled vector, a binomial
   LogisticRegression (Newton on masked_gram) on the components; then the
   same through SQLTransformer (a derived column) and RFormula as one
   Pipeline, its PipelineModel saved, loaded and predicting bit for bit as
   before. Each step twice on the card (the first with its launch counts
   and host-clock time, the second under torch.profiler; bit-identical),
   the exact results over every clean row against numpy (labels, median,
   splits, bucket counts, counts, the chi-square tables), every result on
   the first 10^6 clean rows against the CPU float64 run of the same steps
   on the same rows.
16. the rest of models/: (a) Spark's text-classification pipeline on 10^5
   seeded raw documents (20-100 words, capitals and punctuation, ~30% stop
   words, 20,000 content words in 4 topics of Zipf vocabularies, each
   document from one topic, its label): Tokenizer, RegexTokenizer (\\W+,
   minTokenLength 2), StopWordsRemover, NGram(2), HashingTF(1024),
   CountVectorizer (vocabSize 4096, minDF 5) on the bigrams, IDF and
   MultilayerPerceptronClassifier [1024, 64, 32, 4] (100 Adam steps,
   stepSize 0.03) on the TF-IDF; every token, n-gram, bucket count, the
   vocabulary and its order and the document frequencies exact against
   numpy written here, the IDF weights within 1e-6; the MLP fit twice
   (bit-identical), its loss history within 1e-4 and accuracy within 1e-3
   of its float64 run on the card from the same draws; as an extra case
   the MLP on the TF-IDF's unit rows (Normalizer, p = 2) against its own
   float64 run, with the same limits; (b) ALS
   on seeded ratings of MovieLens 20M's shape (20,000,263 ratings, 138,493
   users, 26,744 movies, half stars, at least 20 a user, Zipf popularity,
   planted rank-10 taste plus noise): explicit at Spark's defaults and
   implicit (alpha 1.0), each twice (bit-identical) with its launch counts,
   recommendForAllUsers(10) and recommendForAllItems(10); against the
   float64 run on the card from the same initial factors: losses and
   training RMSE within 1e-4, 10^5 held-out predictions within 1e-3, every
   top-10 place where float64's scores are 1e-4 apart; the training RMSE
   within 10% of the planted noise; (c) the sorted segment sum at the
   half-steps' shapes (20 M × 100 outer products and 20 M × 10 right-hand
   sides onto the users and onto the movies) against its plain version,
   timed beside index_add_ and torch.segment_reduce; (d) small cases of
   the three modules against TEXT_REC_GOLDEN (the JAX package's float32
   output). The device time of the three TPU kernels' ports at their main
   shapes joins phase 6.
17. the fused pipeline (ops/compiler.py: a plan-keyed cache with shape
   buckets) under the reference app, every earlier phase having run
   through it: (a) ``python -m sparkdq4ml_tpu_torch.app`` on the
   three datasets, each from a fresh plan cache, counters and statstore,
   its last line equal to APP_REPORT_GOLDEN (the JAX example's), its RMSE,
   r2, predict(40) and DQ row counts against GOLDEN; (b) the app path on
   the 10^7-row table with the pipeline on and off: every column and the
   mask of the clean frame and the fit's numbers bit-identical, the
   statstore's two WHERE selectivities equal to the run's kept/in counts
   (the second phase 5's), the steady DQ phase both ways (median of 3,
   in turns); (c) at 1,040 rows, the same on against off bits, one plan
   run at two hoisted literals in turns (WHERE price_no_min > 0 and > 50,
   every result kept) each against its eager run bit for bit, the kernels
   of a flush both ways (the kernel nodes of a CUDA graph captured from
   it, and the launches and device kernels under torch.profiler over 20),
   the host time of a hit flush piece by piece, the steady DQ phase both
   ways (median of 21) and no synchronizing call in a hit flush; (d) no
   fallback to eager replay over the whole script, the pipeline's
   counters.

The last lines are the kernel table (with every phase's results and the
optional modules) as one JSON object, the card's name and power limit from
nvidia-smi, and {"ok": true, "device": {...}}.
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
                 (1_000_000, 512),
                 # phase 15's scatters: the scaled expansion, RFormula's
                 (10_000_000, 14), (10_000_000, 20))
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

    from sparkdq4ml_tpu_torch.frame import native_csv
    from sparkdq4ml_tpu_torch.ops import kernels

    spark = session(device)
    for name, (rows, rmse, r2, p40) in GOLDEN.items():
        df = read_dataset(spark, name)
        read = native_csv.reads.last()
        if read["engine"] != "native" or read["mode"] != "oneshot":
            raise AssertionError(f"{name}: the read took {read}, not the "
                                 "native engine")
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
    """Returns the card's result, the CPU float64 plain result, the launch
    counts of the main path's run, the app-phase wall times in s (that run
    first, then APP_RUNS - 1 more), and one run's stage times in ms."""
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
    return card, plain, counts, app_s, stages


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


def one_slot_cases():
    """(name, kernel, x, seg, size) at the global sums' shape: every slot
    of the full table onto one slot, the rows dq_rules drops weighted 0.
    stat.corr/cov stack (weight, weighted a, weighted b) into one launch
    (frame/stat.py:_sums), describe, summary and avg sum one column
    (frame/aggregates.py:global_agg's fsum); both pass no id column (seg
    None, the whole-table form), and the same sums with an all-zero id
    column hold the form that reads ids at one slot."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    guest, price = full_table(FULL_ROWS)
    p = torch.as_tensor(price, dtype=torch.float32, device="cuda")
    g = torch.as_tensor(guest, device="cuda").to(torch.float32)
    w = kernels.dq_rules(p, g)[2].to(torch.float32)
    one_slot = torch.zeros(FULL_ROWS, dtype=torch.int64, device="cuda")
    stacked = torch.stack([w, p * w, p * p * w], dim=1)
    return [("dense one slot C=3", "dense_segment_sum", stacked, one_slot, 1),
            ("dense one slot C=1", "dense_segment_sum", p * w, one_slot, 1),
            ("dense one slot no ids C=3", "dense_segment_sum", stacked, None,
             1),
            ("dense one slot no ids C=1", "dense_segment_sum", p * w, None,
             1)]


def edge_segment_cases(device: str, seed: int = 0):
    """Small and ragged shapes: no row, one row, tile and block edges,
    a float32 table of exactly 48 KB of per-warp tables (the default
    shared-memory ceiling), the largest float32 table that fits shared
    memory, runs of one row; the whole form (no ids) at one block and at
    many, with a last chunk whole or partial, at one to SEGSUM_REG_COLS
    columns; views off the 16-byte grid, which each form reads value by
    value."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    rng = np.random.default_rng(seed)
    biggest = kernels.SEGSUM_SMEM_BYTES // (kernels.SEGSUM_WARPS * 4) - 32
    out = []
    for n, size, cols in ((0, 3, 1), (1, 1, 1), (31, 4, 2), (32, 4, 1),
                          (33, 2, 3), (4097, 5, 1), (65_537, 300, 2),
                          (65_537, 1536, 1), (100_003, biggest, 1),
                          (100_003, 90_000, 1)):
        x = torch.as_tensor(rng.normal(size=(n, cols)), device=device)
        seg = torch.as_tensor(rng.integers(0, size, n), device=device)
        out.append((f"dense n={n} size={size} C={cols}", "dense_segment_sum",
                    x, seg, size))
        out.append((f"sorted n={n} size={size} C={cols}",
                    "sorted_segment_sum", x, torch.sort(seg).values, size))
    # ids outside [0, size): the kernel drops them, as its plain version
    for n, size in ((4097, 5), (65_537, 300)):
        x = torch.as_tensor(rng.normal(size=(n, 2)), device=device)
        seg = torch.as_tensor(rng.integers(-3, size + 3, n), device=device)
        out.append((f"dense n={n} size={size} ids outside",
                    "dense_segment_sum", x, seg, size))
    # without ids: one block up to 8,191 rows, a partial last chunk where n
    # is odd, the global sums' 9,611,537 clean rows
    for n in (0, 1, 27, 33, 4097, 65_537, 9_611_537):
        for cols in (1, 2, 3):
            x = torch.as_tensor(rng.normal(size=(n, cols)), device=device)
            out.append((f"dense n={n} C={cols} no ids", "dense_segment_sum",
                        x if cols > 1 else x[:, 0].contiguous(), None, 1))
    x = torch.as_tensor(rng.normal(size=(65_537, kernels.SEGSUM_REG_COLS)),
                        device=device)
    out.append((f"dense n=65537 C={kernels.SEGSUM_REG_COLS} no ids",
                "dense_segment_sum", x, None, 1))
    # views that start off the 16-byte grid (the kernel's scalar loads)
    x = torch.as_tensor(rng.normal(size=(65_538, 3)), device=device)
    x1 = torch.as_tensor(rng.normal(size=65_538), device=device)
    for size in (1, 5, 300):
        seg = torch.as_tensor(rng.integers(0, size, 65_538), device=device)
        out.append((f"dense offset view n=65537 size={size} C=3",
                    "dense_segment_sum", x[1:], seg[1:], size))
    out.append(("dense offset view n=65537 C=3 no ids", "dense_segment_sum",
                x[1:], None, 1))
    out.append(("dense offset view n=65537 C=1 no ids", "dense_segment_sum",
                x1[1:], None, 1))
    return out + sorted_edge_cases(device, rng)


def sorted_edge_cases(device: str, rng):
    """The sorted kernel's edges (sorted_segment_plan), each case run in
    float32 and float64 by check_segment_sum: runs that end on a block's
    or a stage's first row and a row either side of it, under both types'
    plans; one segment over the 9,611,537 clean rows' count (every block
    a middle one), and one that leaves two empty slots before it; runs of
    one row; fewer rows than a block takes; ids below 0 at the start and at
    size and past it at the end; 1,000 ids spread over 10^7 slots (gaps of
    about 10^4 slots, zeroed by a memset) and 2,000,000 onto 70,000 slots
    whose first 65,000 the first block zeroes alone; five and seven
    columns (a count known only when the kernel runs) and 10,000 (read in
    slabs of columns); views off the 16-byte grid, which it copies value
    by value."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    def case(name, x, seg, size):
        return (f"sorted {name}", "sorted_segment_sum",
                torch.as_tensor(x, device=device),
                torch.as_tensor(seg, device=device), size)

    out = []
    n = 1_200_000
    for cols in (1, 3):
        edges = set()
        for elem in (4, 8):
            plan = kernels.sorted_segment_plan(n, cols, elem, n)
            for b in range(plan.blocks):
                r0 = b * plan.rows_per_block
                for k in range(-(-plan.rows_per_block // plan.stage_rows)):
                    edges.update((r0 + k * plan.stage_rows + d
                                  for d in (-1, 0, 1)))
        cuts = np.asarray(sorted(e for e in edges if 0 < e < n))
        seg = np.searchsorted(cuts, np.arange(n), "right")
        out.append(case(f"stage and block edges n={n} C={cols}",
                        rng.normal(size=(n, cols)), seg, int(seg[-1]) + 1))
    whole = 9_611_537
    out.append(case(f"one segment n={whole}", rng.normal(size=whole),
                    np.zeros(whole, np.int64), 1))
    out.append(case(f"one segment after two empty n={whole} C=2",
                    rng.normal(size=(whole, 2)), np.full(whole, 2), 3))
    out.append(case("runs of one row n=65537 C=2",
                    rng.normal(size=(65_537, 2)), np.arange(65_537), 65_537))
    for n, size, cols in ((100, 7, 3), (1023, 40, 1), (2049, 40, 2)):
        out.append(case(f"n={n} size={size} C={cols} (few blocks)",
                        rng.normal(size=(n, cols)),
                        np.sort(rng.integers(0, size, n)), size))
    for n, size in ((4097, 5), (65_537, 300)):
        out.append(case(f"n={n} size={size} ids outside",
                        rng.normal(size=(n, 2)),
                        np.sort(rng.integers(-3, size + 3, n)), size))
    out.append(case("sparse 1000 ids onto 10^7 slots (memset)",
                    rng.normal(size=1000),
                    np.sort(rng.choice(10**7, 1000, replace=False)), 10**7))
    # under the memset's ratio: the first block zeroes 65,000 slots alone
    out.append(case("n=2000000 size=70000 ids in the top 5000",
                    rng.normal(size=2_000_000),
                    np.sort(rng.integers(65_000, 70_000, 2_000_000)),
                    70_000))
    # rows past a stage's width, read in slabs of columns
    out.append(case("wide rows n=3000 C=10000",
                    rng.normal(size=(3000, 10_000)),
                    np.sort(rng.integers(0, 5, 3000)), 5))
    for cols in (5, 7):
        out.append(case(f"n=65537 size=300 C={cols}",
                        rng.normal(size=(65_537, cols)),
                        np.sort(rng.integers(0, 300, 65_537)), 300))
    # views that start off the 16-byte grid (value-by-value copies)
    x = torch.as_tensor(rng.normal(size=(65_538, 3)), device=device)
    x1 = torch.as_tensor(rng.normal(size=65_538), device=device)
    seg = torch.as_tensor(np.sort(rng.integers(0, 300, 65_538)),
                          device=device)
    out.append(("sorted offset view n=65537 size=300 C=3",
                "sorted_segment_sum", x[1:], seg[1:], 300))
    out.append(("sorted offset view n=65537 size=300 C=1",
                "sorted_segment_sum", x1[1:], seg[1:], 300))
    return out


def check_two_streams(seed: int = 1) -> dict:
    """Sorted and dense segment sums queued on two streams at once, each
    stream with its own ticket counters and partials (kernels.
    _stream_state), against the same calls on one stream, bit for bit."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    rng = np.random.default_rng(seed)
    n = 2_000_000
    x = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32,
                        device="cuda")
    seg = torch.as_tensor(np.sort(rng.integers(0, 5000, n)), device="cuda")
    slots = torch.as_tensor(rng.integers(0, 41, n), device="cuda")
    calls = [lambda: kernels.sorted_segment_sum(x, seg, 5000),
             lambda: kernels.sorted_segment_sum(x[:, 0], seg, 5000),
             lambda: kernels.dense_segment_sum(x, slots, 41)]
    want = [f() for f in calls]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(8):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append([f() for f in calls])
    torch.cuda.synchronize()
    bad = sum(not same_bits(g, w) for per in got for run in per
              for g, w in zip(run, want))
    if bad:
        raise AssertionError(f"segment sums on two streams: {bad} results "
                             "differ from one stream's")
    return {"streams": 2, "rounds": 8, "calls": 2 * 8 * len(calls)}


def at_offset(x, dtype):
    """``x`` in ``dtype`` at the same storage offset, so that a view off
    the 16-byte grid stays off it in either type."""
    import torch

    off = x.storage_offset()
    if x.dtype == dtype or off == 0:
        return x.to(dtype)
    flat = torch.empty(off + x.numel(), dtype=dtype, device=x.device)
    out = flat[off:].view(x.shape)
    out.copy_(x)
    return out


def check_segment_sum(cases) -> dict:
    """Each case in float32 and float64: two kernel runs bit-identical,
    the float32 kernel within 1e-5 Σ|x| of the float64 plain version
    (index_add_; sum at one slot and without ids) per segment, the float64
    kernel within 1e-12 Σ|x| of it; each call one launch, one device
    kernel and no more than one memset in either type (none at n = 0;
    check_one_kernel).
    A dense case whose table does not fit takes the sorted kernel after a
    stable sort, as ops/segments.py does. Returns {name: max |float32
    kernel - float64 plain|}."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    errs, per_call = {}, {}
    for name, kernel, x, seg, size in cases:
        xs = x.double().cpu()
        sc = None if seg is None else seg.cpu()
        want = kernels.dense_segment_sum(xs, None, 1) if seg is None \
            else kernels.segment_sum_reference(xs, sc, size)
        bound = kernels.dense_segment_sum(xs.abs(), None, 1) if seg is None \
            else kernels.segment_sum_reference(xs.abs(), sc, size)
        del xs
        for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            xd, sd, fn = at_offset(x, dtype), seg, getattr(kernels, kernel)
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
            per_call[f"{name} {str(dtype)[6:]}"] = \
                check_one_kernel(fn.__name__, xd, sd, size)
    log(f"segment sums: bit-identical over two runs and within bounds: "
        f"{errs}; device kernels, memsets and host launches a call: "
        f"{per_call}")
    return errs


def graph_kernels(fn) -> tuple:
    """The kernel nodes and the memset nodes of a CUDA graph captured from
    one call of ``fn`` on a side stream, after a warm-up call there: the
    device kernels and fills a call runs, counted without the profiler,
    which has lost the device events of single-call traces late in this
    script."""
    import ctypes

    import torch

    cudart = ctypes.CDLL("libcudart.so.12", mode=os.RTLD_NOLOAD | os.RTLD_LAZY)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    graph = torch.cuda.CUDAGraph(keep_graph=True)    # never replayed
    with torch.cuda.graph(graph, stream=side):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cudart.cudaGraphGetNodes(handle, None, ctypes.byref(count)):
        raise RuntimeError("cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    cudart.cudaGraphGetNodes(handle, nodes, ctypes.byref(count))
    kernel_nodes = memset_nodes = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        cudart.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kernel_nodes += kind.value == 0            # cudaGraphNodeTypeKernel
        memset_nodes += kind.value == 2            # cudaGraphNodeTypeMemset
    graph.reset()
    return kernel_nodes, memset_nodes


def check_one_kernel(kernel, x, seg, size) -> tuple:
    """(device kernels, memset nodes, launches) of one call of the segment
    sum ``kernel`` on these inputs: the kernel and memset nodes of a CUDA
    graph captured from the call (``graph_kernels``) and the wrapper's
    launch count; raises unless they are one kernel, at most one memset
    and one launch (none at n = 0, where the wrapper launches nothing)."""
    from sparkdq4ml_tpu_torch.ops import kernels

    def launched():
        return kernels.launches.snapshot()[kernel]

    wrapper = getattr(kernels, kernel)
    fn = lambda: wrapper(x, seg, size)
    before = launched()
    if x.shape[0] == 0:
        fn()
        got = (0, 0, launched() - before)
    else:
        nodes, memsets = graph_kernels(fn)   # a warm-up call, then the
        got = (nodes, memsets, (launched() - before) // 2)   # captured one
    if x.shape[0] == 0:
        ok = got == (0, 0, 0)
    else:
        ok = got[0] == 1 and got[1] <= 1 and got[2] == 1
    if not ok:
        raise AssertionError(f"{kernel} at {tuple(x.shape)} onto {size} "
                             f"slots: {got} (device kernels, memsets, "
                             f"launches), expected one kernel, at most one "
                             f"memset and one launch a call")
    return got


# Single calls that traced_calls traces, each under a trace of its own.
TRACED_CALLS = 5


def traced_calls(fn, calls: int = TRACED_CALLS) -> dict:
    """``calls`` single calls of ``fn`` after a warm-up, each traced alone
    (``trace_call``): the median of their device times (ms) over the
    traces that kept a device event (None if none did), and the most
    device events and kernel launches a call made."""
    import torch

    fn()                                                # warm-up
    torch.cuda.synchronize()
    traces = [trace_call(fn) for _ in range(calls)]
    kept = [t["device_ms"] for t in traces if t["device_kernels"]]
    return {"device_ms": float(np.median(kept)) if kept else None,
            "device_events": max(t["device_kernels"] for t in traces),
            "host_launches": max(t["host_launches"] for t in traces),
            "traces_kept": len(kept),
            "names": sorted({n for t in traces for n in t["names"]})}


# Rounds of (library, wrapper, wrapper, library) segsum_times takes.
SEGSUM_TURNS = 3


def segsum_times(name, kernel, x, seg, size, runs: int = TIMED_RUNS,
                 index_add: bool = False) -> dict:
    """One segment-sum kernel, its plain version (index_add_ into zeros;
    sum at one slot) and the library call (index_add_ for slot ids, sum
    over the rows at one slot, torch.segment_reduce for contiguous
    segments) at one of segment_cases' or one_slot_cases' shapes: the
    medians of CUDA-event-timed wrapper and library calls, taken in turns,
    and the device time of single calls of the kernel and of the library
    call from a profiler trace; the wrapper's host path is the first less
    the second. (One kernel a dense call is asserted by check_one_kernel.)
    ``runs`` calls a median; ``index_add`` also times index_add_ into
    zeros beside a sorted kernel (``index_add_ms``)."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    fn = getattr(kernels, kernel)
    n = x.shape[0]
    cols = x.shape[1] if x.ndim == 2 else 1
    if size == 1:
        library = lambda: x.sum(0, keepdim=True)
        call = "sum(dim=0)"
    elif kernel == "dense_segment_sum":
        library = lambda: torch.zeros((size, cols), dtype=x.dtype,
                                      device=x.device).index_add_(0, seg, x)
        call = "index_add_"
    else:
        lengths = torch.bincount(seg, minlength=size)
        library = lambda: torch.segment_reduce(x, "sum", lengths=lengths)
        call = "torch.segment_reduce(lengths=...)"
    id_bytes = 0 if seg is None else 8
    elem = x.element_size()
    moved = n * (id_bytes + elem * cols) + size * cols * elem
    plain = ((lambda: x.sum(0, keepdim=True)) if seg is None
             else (lambda: kernels.segment_sum_reference(x, seg, size)))
    # the wrapper and the library call in turns (library, wrapper, wrapper,
    # library, SEGSUM_TURNS times), each the median of its medians: host
    # time varies between moments of one run, and at one slot the wrapper
    # takes little more than its host path
    turns = {"kernel": [], "library": []}
    for who in ("library", "kernel", "kernel", "library") * SEGSUM_TURNS:
        turns[who].append(median_ms(library if who == "library"
                                    else lambda: fn(x, seg, size), runs))
    ms, library_ms = (float(np.median(turns[k]))
                      for k in ("kernel", "library"))
    traced = traced_calls(lambda: fn(x, seg, size))
    library_traced = traced_calls(library)
    device_ms = traced["device_ms"]
    extra = {}
    if index_add:
        extra["index_add_ms"] = median_ms(
            lambda: torch.zeros((size, cols), dtype=x.dtype,
                                device=x.device).index_add_(0, seg, x), runs)
    return {**extra, "case": name, "n": n, "size": size, "columns": cols,
            "dtype": str(x.dtype)[6:], "ids": seg is not None,
            "ms": ms, "device_ms": device_ms,
            "traces_kept": traced["traces_kept"],
            "host_path_ms": None if device_ms is None else ms - device_ms,
            "kernel_names": traced["names"],
            "plain_ms": median_ms(plain, runs),
            "library_ms": library_ms, "library_call": call,
            "turns_ms": turns,
            "library_device_ms": library_traced["device_ms"],
            "library_device_events": library_traced["device_events"],
            "bound_ms": 1e3 * moved / HBM_BYTES_PER_S, "bound_by": "bytes"}


def graph_ms(fn, calls: int = 20, rounds: int = 5) -> float:
    """The device time of one call of ``fn`` (ms): ``calls`` calls captured
    in one CUDA graph on a side stream, after a warm-up call there, and
    the median of ``rounds`` replays timed by CUDA events, over ``calls``:
    the kernels and memsets a call runs, without the host path."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    graph.reset()
    return float(np.median(times))


def sorted_zero_forms(seed: int = 3) -> dict:
    """The sorted kernel's two ways to zero the slots no row reaches, on
    the same launch: the blocks' own zeros and a memset before the launch
    (kernels.sorted_segment_plan picks the memset where the output passes
    1 / SEGSUM_SORTED_ZERO_RATIO of the rows' bytes). Float32, one column,
    at shapes either side of that rule: 9,611,537 rows onto 20,556 slots,
    and onto 900,000 (just under it) with ids spread and with ids in the
    top sixteenth (the first block zeroes the rest alone); 131,584 ids
    onto PIC's 16,777,216 slots, an eighth of them, and 1,000 ids onto
    10^7 slots (one block). Each form's device time a call (graph_ms), in
    turns (blocks, memset, memset, blocks), both forms bit for bit alike;
    with the form the plan picks and the byte bound."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    rng = np.random.default_rng(seed)
    rows = 9_611_537
    spread = np.sort(rng.integers(0, 900_000, rows))
    pic = 16_777_216
    shapes = [
        ("9,611,537 rows onto 20,556 slots",
         np.sort(rng.integers(0, 20_556, rows)), 20_556),
        ("9,611,537 rows onto 900,000 slots", spread, 900_000),
        ("9,611,537 rows onto 900,000 slots, ids in the top sixteenth",
         843_750 + spread // 16, 900_000),
        ("131,584 ids onto 16,777,216 slots",
         np.sort(rng.choice(pic, 131_584, replace=False)), pic),
        ("16,448 ids onto 16,777,216 slots",
         np.sort(rng.choice(pic, 16_448, replace=False)), pic),
        ("1,000 ids onto 10^7 slots",
         np.sort(rng.choice(10**7, 1000, replace=False)), 10**7)]
    out = {}
    for name, ids, size in shapes:
        n = len(ids)
        x = torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                            device="cuda")
        seg = torch.as_tensor(ids, device="cuda")
        plan, args = kernels._sorted_call(n, 1, 4, size)
        forms = {}
        for form, memset in (("blocks", 0), ("memset", 1)):
            a = kernels._SortedArgs.from_buffer_copy(args)
            a.memset = memset
            forms[form] = (lambda a=a: kernels._sorted_launch(
                x, seg, size, plan.scratch_bytes, a))
        if not same_bits(forms["blocks"](), forms["memset"]()):
            raise AssertionError(f"sorted zero forms differ at {name}")
        times = {"blocks": [], "memset": []}
        for form in ("blocks", "memset", "memset", "blocks"):
            times[form].append(graph_ms(forms[form]))
        out[name] = {"n": n, "size": size, "blocks": plan.blocks,
                     "plan": "memset" if plan.memset else "blocks",
                     **{f"{f}_ms": float(np.median(t))
                        for f, t in times.items()},
                     "turns_ms": times,
                     "bound_ms": 1e3 * (n * 12 + size * 4) / HBM_BYTES_PER_S}
    log(f"sorted segment sum's zero forms: {out}")
    return out


def host_us(fn, calls: int = 2000, rounds: int = 5) -> float:
    """The host time of one call of ``fn`` (us): the median over
    ``rounds`` of ``calls`` calls in a row, timed on the host's clock, the
    device synchronized between rounds."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter_ns() - t0) / calls / 1e3)
        torch.cuda.synchronize()
    return float(np.median(per_call))


def segsum_host_path(cases) -> dict:
    """At one_slot_cases' column counts without ids: the host time of a
    call of the wrapper, of ``sum``, of the output's allocation by
    torch.empty and of the view the wrapper takes from its stream's batch
    (``kernels._one_slot_output``) instead: what the batch buys. On the
    first 4,096 rows, so that the device keeps up with the calls."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    out = {}
    for name, _, x, seg, size in cases:
        if seg is not None:
            continue
        x = x[:4096]
        shape = (1,) + tuple(x.shape[1:])
        state = kernels._stream_state(x.device, kernels._raw_stream(x.device),
                                      0)
        out[name] = {
            "wrapper_us": host_us(lambda: kernels.dense_segment_sum(x, None,
                                                                    1), 500),
            "sum_us": host_us(lambda: x.sum(0, keepdim=True), 500),
            "empty_us": host_us(lambda: torch.empty(shape, dtype=x.dtype,
                                                    device=x.device)),
            "batch_view_us": host_us(lambda: kernels._one_slot_output(
                state, shape, x.dtype, x.device))}
    log(f"dense_segment_sum host path at one slot, us a call: {out}")
    return out


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


def run_steps(steps, device: str, times=None, runs: int = 1, caps=None):
    """Each (name, fn) of ``steps`` run ``runs`` times (a name in ``caps``
    at most that many times); returns {name: [each run's result]}. With
    ``times`` (a dict), each run's host-clock seconds to a device
    synchronisation are appended to ``times[name]``."""
    import torch

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    outs: dict = {}
    for name, fn in steps:
        for _ in range(min(runs, (caps or {}).get(name, runs))):
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            if times is not None:
                times.setdefault(name, []).append(time.perf_counter() - t0)
            outs.setdefault(name, []).append(out)
    return outs


# Runs of the host-bound steps, fewer than the others' three to keep the
# script inside its time: the window plan is host numpy. The join step
# keeps its three runs for the price > avg_price count check.
SQL_CORE_CAPS = {"window": 1}
# IN (subquery) and LEFT SEMI, and the string-key step, twice: the
# bit-identity check of steps 1-4 needs two runs.
SQL_REST_CAPS = {"in_semi": 2, "string_keys": 2}


def run_sql_core(spark, clean, times=None, runs: int = 1):
    """The six steps on a ``clean_table``, the host-bound ones
    ``SQL_CORE_CAPS`` times. Returns {step: [each run's result
    frames]}."""
    return run_steps(sql_core_steps(spark, clean), spark.device.type,
                     times, runs, SQL_CORE_CAPS)


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


# Intra-op threads of each CPU reference process (the card's machine has 8
# cores; the three references run at once, before any card phase).
CPU_REFERENCE_THREADS = 3


def _cpu_reference_jobs():
    """The CPU float64 runs that no card state feeds: phases 7-8's, 11's
    and 12's."""
    return (("sql", cpu_reference), ("report", report_reference),
            ("builtins", builtin_reference))


def _cpu_reference_worker(name: str, rows: int, queue, tmp: str) -> None:
    """The CPU reference ``name`` on full_table(rows), in a worker process.
    Its result (about 3 GB for phases 7-8 at 10^7 rows, millions of string
    cells among it) goes through a file in ``tmp``, or through ``queue``
    itself where the file cannot be written: puts (name, kind, the path or
    the result, the reference's seconds, the write's seconds, the time it
    was ready), or (name, "error", traceback, ...)."""
    import pickle
    import traceback

    import torch

    torch.set_num_threads(CPU_REFERENCE_THREADS)
    guest, price = full_table(rows)
    try:
        t0 = time.perf_counter()
        out = dict(_cpu_reference_jobs())[name](guest, price)
        seconds = time.perf_counter() - t0
    except Exception:
        queue.put((name, "error", traceback.format_exc(), None, None, None))
        return
    t0 = time.perf_counter()
    path = os.path.join(tmp, f"{name}.pkl")
    try:
        with open(path, "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    except OSError:
        queue.put((name, "result", out, seconds, None, time.time()))
        return
    queue.put((name, "file", path, seconds, time.perf_counter() - t0,
               time.time()))


class CpuReference:
    """The CPU float64 runs of phases 7-8, 11 and 12, one spawned process
    each, all started together before the kernels' build. ``wait()``
    returns when all three have ended, and the script calls it before
    phase 3, so no card phase shares the host with them: every host-clock
    time the script reports is taken after they end. ``result(name)``
    loads one; ``stop()`` ends the processes and removes what they left,
    whatever happened."""

    def __init__(self, rows: int = FULL_ROWS):
        import multiprocessing
        import tempfile

        ctx = multiprocessing.get_context("spawn")
        self.queue = ctx.Queue()
        self.ready: dict = {}
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_reference_")
        self.procs = [ctx.Process(target=_cpu_reference_worker,
                                  args=(name, rows, self.queue, self.tmp),
                                  daemon=True)
                      for name, _ in _cpu_reference_jobs()]
        for proc in self.procs:
            proc.start()

    def wait(self) -> float:
        """Blocks until every reference is ready; returns the seconds
        waited."""
        import queue as queue_mod

        t0 = time.perf_counter()
        while len(self.ready) < len(self.procs):
            try:
                item = self.queue.get(timeout=5)
                self.ready[item[0]] = item[1:]
            except queue_mod.Empty:
                if not any(proc.is_alive() for proc in self.procs):
                    raise RuntimeError(
                        "a CPU reference process ended without its result "
                        f"(exit codes {[p.exitcode for p in self.procs]})"
                    ) from None
        for proc in self.procs:
            proc.join()
        return time.perf_counter() - t0

    def result(self, name: str) -> tuple:
        """(the reference ``name``, {its seconds in its process, the
        write's and the read's seconds})."""
        import pickle

        kind, out, seconds, write_s, _ready = self.ready.pop(name)
        if kind == "error":
            raise RuntimeError(f"the CPU reference {name!r} failed:\n{out}")
        timing = {"reference_s": seconds, "write_s": write_s}
        if kind == "file":
            path, t0 = out, time.perf_counter()
            try:
                with open(path, "rb") as f:
                    out = pickle.load(f)
            finally:
                os.remove(path)
            timing["read_s"] = time.perf_counter() - t0
        return out, timing

    def stop(self) -> None:
        import shutil

        for proc in self.procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.terminate()
                proc.join()
        self.queue.close()
        self.ready.clear()
        shutil.rmtree(self.tmp, ignore_errors=True)


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
    two card runs and the ``price > avg_price`` count the same in every
    join run; each step's median of 3 host-clock times (the window step,
    whose plan is host numpy, once); one more run under
    torch.profiler for the device's idle share."""
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
                             "the join runs")

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
        f"price > avg_price rows in the join runs {over_counts}; steps 1-2 "
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
    """Phase 8's steps on a ``clean_table``, the host-bound ones
    ``SQL_REST_CAPS`` times: {step: [each run's result frames]}."""
    return run_steps(sql_rest_steps(spark, clean), spark.device.type,
                     times, runs, SQL_REST_CAPS)


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
    3 host-clock times (of 2 for steps 2 and 4) and the band's encoding
    time."""
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
# Phase 9: the classifiers
# ---------------------------------------------------------------------------

# The tour's classifier section (examples/ml_pipeline_tour.py:87-94, and
# its LinearSVC at :129-132) on dataset-full: the JAX package's output on
# the CPU in float64 (tests/test_torch_classification.py holds these
# constants to it). Iterations, AUC and accuracy are held exactly, the
# coefficients and intercepts within CLASSIFIER_RTOL.
ML_TOUR_GOLDEN = {
    "logistic": {"coef": 0.34458383192309566,
                 "intercept": -8.916455944033938, "iterations": 6,
                 "auc": 0.9999999999999999},
    "svc": {"coef": 0.23687406661626967, "intercept": -6.079708355376644,
            "accuracy": 1.0},
}
CLASSIFIER_RTOL = 1e-3      # card float32 coefficients against float64
OBJECTIVE_RTOL = 1e-5       # the final objective against float64
CURVE_ATOL = 1e-9           # areaUnderROC and areaUnderPR against float64
ITERATION_SLACK = 2         # iterations against float64
BAND_PRICES = (60.0, 140.0)     # band: price < 60 -> 0, < 140 -> 1, else 2
# OneVsRest's binary fits are unregularized, and bands 0 and 2 against the
# rest are nearly separable (only guests 7-9 and 23-25 are mixed): the
# smallest eigenvalue of their Hessian is about the Newton jitter, 100 eps
# (1 + max diag H), which is 1.2e-5 in float32 and 2.2e-14 in float64. So
# float32 Newton converges linearly there (about 0.55 a step) and stops
# later (17 and 26 iterations against 12 and 12), at a point as optimal
# (its objective within OBJECTIVE_RTOL) but up to 2e-3 away in
# coefficients. The JAX package does the same in float32
# (tests/test_torch_classification.py holds the port to it there). Those
# two binary fits are held by the fit's predictions and metrics and by
# their objectives; their iterations and coefficient errors are reported.
UNRESOLVED_IN_FLOAT32 = {"ovr_band": (0, 2)}
# The multinomial fit's middle-band coefficient is 25 times smaller than
# the other two: its block's coefficients are held against their largest.
BLOCK_SCALED = ("softmax_band",)
# The CPU float64 reference of the FISTA fits took 35-40 s each at full
# size on the card's host, and that of the multinomial and OneVsRest fits
# 22-24 s each, which the script's time cannot hold: those four are held
# on the first HEAD_ROWS clean rows, on the card as on the CPU, and timed
# on the card at full size.
HEAD_ROWS = 1_000_000
HELD_ON_HEAD = ("fista_l2", "svc_l2", "softmax_band", "ovr_band")


def tour_classifier(device: str) -> dict:
    """The tour's classifier section through TorchSession: the DQ chain,
    VectorAssembler, label = guest > 25, LogisticRegression(max_iter=50,
    reg_param=0.01) graded by BinaryClassificationEvaluator, then
    LinearSVC(max_iter=100, reg_param=0.01) and its accuracy."""
    from sparkdq4ml_tpu_torch.models import (BinaryClassificationEvaluator,
                                             LinearSVC, LogisticRegression)

    spark = session(device)
    fdf = dq_clean(spark, read_dataset(spark, "full"))
    ldf = fdf.with_column("label", (fdf.col("guest") > 25).cast("double"))
    lr = LogisticRegression(max_iter=50, reg_param=0.01).fit(ldf)
    auc = BinaryClassificationEvaluator().evaluate(lr.transform(ldf))
    svc = LinearSVC(max_iter=100, reg_param=0.01).fit(ldf)
    out = svc.transform(ldf).to_pydict()
    spark.stop()
    return {"logistic": {"coef": float(lr.coefficients[0]),
                         "intercept": lr.intercept, "auc": auc,
                         "iterations": lr.summary.total_iterations},
            "svc": {"coef": float(svc.coefficients[0]),
                    "intercept": svc.intercept,
                    "accuracy": float(np.mean(out["prediction"]
                                              == out["label"]))}}


def check_ml_tour_golden(device: str) -> dict:
    got = tour_classifier(device)
    for fit, want in ML_TOUR_GOLDEN.items():
        for k, v in want.items():
            g = got[fit][k]
            ok = (abs(g - v) <= CLASSIFIER_RTOL * abs(v)
                  if k in ("coef", "intercept") else g == v)
            if not ok:
                raise AssertionError(f"tour {fit} on dataset-full: {k} {g}, "
                                     f"the JAX package's {v}")
    log(f"tour classifiers on dataset-full, {device} float32: {got}")
    return got


def classifier_fits():
    """(name, label column, estimator, metrics) of the seven fits of phase
    9(b): binomial Newton on l1 and l2, binomial FISTA on l2, multinomial
    Newton, NaiveBayes and OneVsRest on band, LinearSVC on l2."""
    from sparkdq4ml_tpu_torch.models import (LinearSVC, LogisticRegression,
                                             NaiveBayes, OneVsRest)

    binary, multi = ("areaUnderROC", "areaUnderPR"), ("f1", "accuracy")
    return (
        ("newton_l1", "l1", LogisticRegression(
            max_iter=50, reg_param=0.01, label_col="l1"), binary),
        ("newton_l2", "l2", LogisticRegression(
            max_iter=50, reg_param=0.01, label_col="l2"), binary),
        ("fista_l2", "l2", LogisticRegression(
            max_iter=100, reg_param=0.01, elastic_net_param=0.5,
            label_col="l2"), binary),
        ("softmax_band", "band", LogisticRegression(
            max_iter=50, reg_param=0.01, label_col="band"), multi),
        ("svc_l2", "l2", LinearSVC(max_iter=100, reg_param=0.01,
                                   label_col="l2"), binary),
        ("nb_band", "band", NaiveBayes(label_col="band"), multi),
        ("ovr_band", "band", OneVsRest(LogisticRegression(max_iter=50),
                                       label_col="band"), multi))


def labelled(clean):
    """The clean table assembled ([guest]) with the three label columns:
    l1 = guest > 25 (the tour's, separable), l2 = price > 102.5
    (overlapping around guests 16-17) and the price band."""
    from sparkdq4ml_tpu_torch.models import VectorAssembler

    df = VectorAssembler(["guest"], "features").transform(clean)
    price = df.col("price")
    return df.with_columns({
        "l1": (df.col("guest") > 25).cast("double"),
        "l2": (price > 102.5).cast("double"),
        "band": ((price >= BAND_PRICES[0]).cast("double")
                 + (price >= BAND_PRICES[1]).cast("double"))})


def fit_numbers(model) -> dict:
    """A fitted classifier's coefficients, intercepts, iterations and final
    objective on the host (NaiveBayes: log likelihoods and log priors); a
    OneVsRest model's of each binary fit."""
    from sparkdq4ml_tpu_torch.models import (LinearSVCModel,
                                             LogisticRegressionModel,
                                             OneVsRestModel)

    if isinstance(model, OneVsRestModel):
        parts = [fit_numbers(m) for m in model.models]
        return {k: [p[k] for p in parts]
                for k in ("coef", "intercept", "iterations", "objective")}
    if isinstance(model, LogisticRegressionModel):
        s = model.summary
        return {"coef": np.ravel(model.coefficient_matrix).tolist(),
                "intercept": np.ravel(model.intercept_vector).tolist(),
                "iterations": s.total_iterations,
                "objective": float(s.objective_history[-1])}
    if isinstance(model, LinearSVCModel):
        return {"coef": model.coefficients.tolist(),
                "intercept": [model.intercept],
                "iterations": model.iterations,
                "objective": float(model.objective_history[-1])}
    return {"coef": np.ravel(model.theta).tolist(),
            "intercept": model.pi.tolist()}


def evaluated(model, df, label: str, metrics) -> tuple:
    """The model's metrics on ``df`` and its predictions on the valid rows
    (int8, on the host). A LinearSVC's rawPrediction is [-margin, margin]:
    its margin is graded, as the evaluator takes one score a row."""
    from sparkdq4ml_tpu_torch.models import (BinaryClassificationEvaluator,
                                             MulticlassClassificationEvaluator)

    out = model.transform(df)
    score = "rawPrediction"
    if score in out.columns and out._column_values(score).ndim == 2:
        out = out.with_column("margin", out._column_values(score)[:, 1])
        score = "margin"
    res = {}
    for m in metrics:
        ev = (BinaryClassificationEvaluator(m, label_col=label,
                                            raw_prediction_col=score)
              if m.startswith("area") else
              MulticlassClassificationEvaluator(m, label_col=label))
        res[m] = ev.evaluate(out)
    pred = out._column_values("prediction")[out.mask]
    return res, pred.cpu().numpy().astype(np.int8)


def host_syncs(fn) -> int:
    """The synchronizing CUDA calls (device-to-host reads among them) that
    one run of ``fn`` makes, counted by torch's sync debug mode."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in seen)


def head_of(df, rows: int = HEAD_ROWS):
    """A frame of ``df``'s slots up to its ``rows``-th valid row (a frame
    keeps its masked slots, and a fit passes over every slot)."""
    import torch

    from sparkdq4ml_tpu_torch.frame.frame import Frame

    seen = torch.cumsum(df.mask.to(torch.int64), 0)
    end = int(torch.searchsorted(seen, rows)) + 1
    return Frame({c: df._column_values(c)[:end] for c in df.columns},
                 mask=df.mask[:end], device=df.device)


def graded(est, df, label: str, metrics) -> dict:
    """One fit of ``est`` on ``df``: its numbers, metrics and predictions,
    with its host-clock seconds (fit and evaluation)."""
    t0 = time.perf_counter()
    model = est.fit(df)
    scores, pred = evaluated(model, df, label, metrics)
    return {**fit_numbers(model), **scores, "pred": pred,
            "all_s": time.perf_counter() - t0}


def grade_classifiers(df, names) -> dict:
    """``graded`` of each fit of ``classifier_fits`` named in ``names``."""
    return {name: graded(est, df, label, metrics)
            for name, label, est, metrics in classifier_fits()
            if name in names}


def time_classifiers(df, runs: int = 3) -> dict:
    """Each fit of ``classifier_fits`` on ``df`` on the card, ``runs``
    times, the launch counts reset just before the first run and read just
    after: the first run's numbers, metrics and predictions, the fit's
    host-clock seconds, its evaluation's, the synchronizing calls of one
    more fit and one fit under torch.profiler."""
    out = {}
    for name, label, est, metrics in classifier_fits():
        model, counts, first = driven(est.fit, df)
        fit_s = [first] + [driven(est.fit, df)[2] for _ in range(runs - 1)]
        t0 = time.perf_counter()
        scores, pred = evaluated(model, df, label, metrics)
        out[name] = {**fit_numbers(model), **scores, "pred": pred,
                     "launches": counts, "fit_s": fit_s,
                     "eval_s": time.perf_counter() - t0,
                     "host_syncs": host_syncs(lambda: est.fit(df)),
                     "profile": profile_run(f"classifier_{name}",
                                            lambda: est.fit(df))}
    return out


def rel_err(got, want, block: bool = False) -> float:
    """The largest |got - want| over |want| element by element, or with
    ``block`` over the block's largest |want| (0 where both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    err = np.abs(got - want)
    top = float(np.max(np.abs(want), initial=0.0))
    scale = np.full_like(want, top) if block else np.abs(want)
    ratio = np.divide(err, scale, out=np.where(err > 0, np.inf, 0.0),
                      where=scale > 0)
    return float(np.max(ratio, initial=0.0))


def check_classifiers(card: dict, cpu: dict) -> tuple:
    """Each fit on the card against the CPU float64 run: predictions row
    for row, AUC and areaUnderPR within CURVE_ATOL, f1 and accuracy equal,
    each final objective within OBJECTIVE_RTOL, iterations within
    ITERATION_SLACK and the coefficients and intercepts within
    CLASSIFIER_RTOL element by element (BLOCK_SCALED against the largest
    of their block), but for the binary fits of UNRESOLVED_IN_FLOAT32.
    Returns each fit's largest such relative error over what the gates
    hold, and over every binary fit."""
    errs, every, bad = {}, {}, []
    for name, got in card.items():
        want = cpu[name]
        fails = len(bad)
        skip = UNRESOLVED_IN_FLOAT32.get(name, ())

        def held(v):
            return [x for i, x in enumerate(v) if i not in skip]
        if not np.array_equal(got["pred"], want["pred"]):
            bad.append(f"{int((got['pred'] != want['pred']).sum())} "
                       "predictions differ")
        for m in ("areaUnderROC", "areaUnderPR"):
            if m in got and not abs(got[m] - want[m]) <= CURVE_ATOL:
                bad.append(f"{m} {got[m]} vs {want[m]}")
        for m in ("f1", "accuracy"):
            if m in got and got[m] != want[m]:
                bad.append(f"{m} {got[m]} vs {want[m]}")
        if "iterations" in got and np.any(np.abs(np.subtract(
                held(np.ravel(got["iterations"])),
                held(np.ravel(want["iterations"])))) > ITERATION_SLACK):
            bad.append(f"iterations {got['iterations']} vs "
                       f"{want['iterations']}")
        block = name in BLOCK_SCALED
        errs[name] = max(rel_err(held(got[k]), held(want[k]), block)
                         for k in ("coef", "intercept"))
        every[name] = max(rel_err(got[k], want[k], block)
                          for k in ("coef", "intercept"))
        if errs[name] > CLASSIFIER_RTOL:
            bad.append(f"coefficients {got['coef']}, intercepts "
                       f"{got['intercept']} vs {want['coef']}, "
                       f"{want['intercept']}")
        if "objective" in got and np.any(
                np.abs(np.subtract(got["objective"], want["objective"]))
                > OBJECTIVE_RTOL * np.abs(want["objective"])):
            bad.append(f"objective {got['objective']} vs "
                       f"{want['objective']}")
        bad[fails:] = [f"{name}: {b}" for b in bad[fails:]]
    if bad:
        raise AssertionError("classifiers against cpu float64: "
                             f"{'; '.join(bad)} (errors {errs})")
    return errs, every


NEWTON_BINOMIAL = ("newton_l1", "newton_l2", "ovr_band")


def check_classifiers_full(rows: int = FULL_ROWS) -> dict:
    """Phase 9(b): the seven fits on the DQ-clean 10^7-row table (cleaned by
    one dq_rules launch), timed in float32 on the card and held against the
    CPU float64 run of the same code (HELD_ON_HEAD on the first HEAD_ROWS
    clean rows, on the card as on the CPU)."""
    import torch

    from sparkdq4ml_tpu_torch.config import float_policy
    from sparkdq4ml_tpu_torch.ops import kernels

    names = [fit[0] for fit in classifier_fits()]
    at_full = [n for n in names if n not in HELD_ON_HEAD]
    t_card = time.perf_counter()
    guest, price = full_table(rows)
    spark, clean = clean_table("cuda", guest[:1000], price[:1000])
    grade_classifiers(labelled(clean), names)               # warm-up
    spark.stop()
    torch.cuda.synchronize()
    kernels.launches.reset()
    spark, clean = clean_table("cuda", guest, price)
    df = labelled(clean)
    torch.cuda.synchronize()
    clean_counts = kernels.launches.snapshot()
    kept = clean.count()
    card = time_classifiers(df)
    card_head = grade_classifiers(head_of(df), HELD_ON_HEAD)
    spark.stop()
    card_s = time.perf_counter() - t_card
    t0 = time.perf_counter()
    with float_policy(torch.float64):
        spark, clean = clean_table("cpu", guest, price)
        cpu_clean_s = time.perf_counter() - t0
        cpu_df = labelled(clean)
        cpu = {**grade_classifiers(cpu_df, at_full),
               **grade_classifiers(head_of(cpu_df), HELD_ON_HEAD)}
        cpu_kept = clean.count()
        spark.stop()
    cpu_s = time.perf_counter() - t0
    by_fit = {}
    for name, res in card.items():
        by_fit[name] = {k: v for k, v in res.items() if k != "pred"}
        by_fit[name]["fit_ms"] = 1e3 * float(np.median(res["fit_s"]))
        if name in card_head:
            by_fit[name]["head"] = {k: v for k, v in card_head[name].items()
                                    if k != "pred"}
        by_fit[name]["cpu_float64"] = {k: v for k, v in cpu[name].items()
                                       if k != "pred"}
    log(f"classifiers at {rows} rows ({kept} clean), card float32: "
        f"{json.dumps(by_fit)}; cpu float64 reference {cpu_s:.1f} s")
    if clean_counts["dq_rules"] != 1 or kept != cpu_kept:
        raise AssertionError(f"the classifier table: {clean_counts}, clean "
                             f"rows card {kept}, cpu {cpu_kept}")
    for name, res in card.items():
        want = (int(np.sum(res["iterations"]))
                if name in NEWTON_BINOMIAL else 0)
        got = res["launches"]
        if got["masked_gram"] != want or got["dq_rules"] != 0:
            raise AssertionError(f"classifier {name}: launches {got}, "
                                 f"expected {want} masked_gram")
    errs, every = check_classifiers(
        {n: card_head.get(n, card[n]) for n in names}, cpu)
    unresolved = ", ".join(f"{n} binary fits {list(i)}"
                           for n, i in UNRESOLVED_IN_FLOAT32.items())
    log(f"classifiers: every gate met; relative coefficient errors {errs} "
        f"({', '.join(BLOCK_SCALED)} against the largest of its block; "
        f"{unresolved} not held by iterations and coefficients, which "
        f"float32 Newton does not resolve there: errors over every binary "
        f"fit {every})")
    return {"rows": rows, "clean_rows": kept, "clean_launches": clean_counts,
            "fits": by_fit, "max_rel_coef_err": errs,
            "max_rel_coef_err_every_binary_fit": every,
            "head_rows": HEAD_ROWS, "held_on_head": HELD_ON_HEAD,
            "unresolved_in_float32": UNRESOLVED_IN_FLOAT32,
            "card_s": card_s, "cpu_clean_s": cpu_clean_s,
            "cpu_float64_reference_s": cpu_s}


# ---------------------------------------------------------------------------
# Phase 10: ingest and IO
# ---------------------------------------------------------------------------

OPTIONAL_MODULES = ("pandas", "pyarrow")
INGEST_RUNS = 3
QUOTED_ROWS = 1_000_000
QUOTED_CHUNK_BYTES = 1 << 17  # the quoted file cut into about 100 chunks
PYTHON_ENGINE_ROWS = 100_000
TOUR_MEAN_ATOL = 1e-3       # examples/io_tour.py: per-guest residual means


def optional_modules() -> dict:
    """Each optional module's version, or None where this machine lacks
    it; a step that needs a missing one does not run."""
    import importlib

    out = {}
    for name in OPTIONAL_MODULES:
        try:
            out[name] = importlib.import_module(name).__version__
        except ImportError:
            out[name] = None
    return out


def _digits(v, width: int):
    """The decimal digits of the non-negative ints ``v`` as (n, width)
    uint8 characters, and which of them the number shows (no leading
    zeros, at least one digit)."""
    chars = np.empty((len(v), width), np.uint8)
    x = v.copy()
    for k in range(width - 1, -1, -1):
        chars[:, k] = 48 + x % 10
        x //= 10
    shown = np.ones(len(v), np.int64)
    for p in range(1, width):
        shown += v >= 10 ** p
    return chars, np.arange(width)[None, :] >= width - shown[:, None]


def write_table_csv(path: str, guest, price, quoted: bool = False) -> int:
    """Headerless ``guest,price`` rows, prices at two decimals, one a line
    (every field in quotes with ``quoted``), built with array arithmetic
    and written with one ``tofile``. The decimal k/100 parses to the
    float64 nearest it, which is what ``np.round(price, 2)`` gave, so the
    file reads back to the columns it was written from. Returns its
    size in bytes."""
    cents = np.rint(price * 100.0).astype(np.int64)
    g = guest.astype(np.int64)
    if cents.min() < 0 or g.min() < 0:
        raise ValueError("write_table_csv writes non-negative values only")
    whole, frac = np.divmod(cents, 100)
    n = len(g)

    def const(ch):
        return np.full((n, 1), ord(ch), np.uint8), np.ones((n, 1), bool)

    q = [const('"')] if quoted else []
    frac_chars, _ = _digits(frac, 2)
    parts = (q + [_digits(g, len(str(g.max())))] + q + [const(",")] + q
             + [_digits(whole, len(str(whole.max()))), const("."),
                (frac_chars, np.ones((n, 2), bool))] + q + [const("\n")])
    chars = np.hstack([c for c, _ in parts])
    shown = np.hstack([v for _, v in parts])
    chars[shown].tofile(path)
    return os.path.getsize(path)


def timed(fn):
    """(fn(), host-clock seconds to a device synchronisation)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def demean_price(g):
    """examples/io_tour.py's applyInPandas function."""
    g = g.copy()
    g["price"] = g["price"] - g["price"].mean()
    return g


def tour_io(spark, F, tmp: str, have: dict) -> dict:
    """Phase 10(a): every section of examples/io_tour.py on dataset-full
    through the session on the card, with each of its asserts, but for a
    step whose optional module this machine lacks."""
    from sparkdq4ml_tpu_torch import col
    from sparkdq4ml_tpu_torch.frame import native_csv

    ran, skipped = [], {}
    df = (spark.read.format("csv").option("inferSchema", "true")
          .load(os.path.join(ROOT, "data", "dataset-full.csv"))
          .with_column_renamed("_c0", "guest")
          .with_column_renamed("_c1", "price"))
    rec = native_csv.reads.last()
    n = df.count()
    if n != 1040 or rec["engine"] != "native" or df.device.type != "cuda":
        raise AssertionError(f"io tour csv: {n} rows, read {rec}")
    ran.append("csv")
    if have["pyarrow"]:
        pq_path = os.path.join(tmp, "inv.parquet")
        df.write.parquet(pq_path)
        back = spark.read.parquet(pq_path)
        if back.count() != n or not np.array_equal(
                np.sort(back.to_pydict()["price"].astype(np.float64)),
                np.sort(df.to_pydict()["price"].astype(np.float64))):
            raise AssertionError("io tour parquet round trip")
        ran.append("parquet")
    else:
        skipped["parquet"] = "pyarrow"
    js_path = os.path.join(tmp, "inv.jsonl")
    df.limit(100).write.json(js_path)
    if spark.read.json(js_path).count() != 100:
        raise AssertionError("io tour json round trip")
    ran.append("json")
    wide = df.limit(5).select("guest", "price").with_column(
        "price2", col("price") * 2)
    long = wide.unpivot("guest", ["price", "price2"], "metric", "amount")
    if long.count() != 10 or \
            list(long.to_pydict()["metric"][:2]) != ["price", "price2"]:
        raise AssertionError("io tour unpivot")
    ran.append("unpivot")
    if have["pandas"]:
        demeaned = df.group_by("guest").apply_in_pandas(
            demean_price, "guest DOUBLE, price DOUBLE")
        means = demeaned.group_by("guest").agg(
            F.avg("price").alias("m")).to_pydict()["m"]
        worst = float(np.max(np.abs(means)))
        if demeaned.count() != n or worst >= TOUR_MEAN_ATOL:
            raise AssertionError(f"io tour applyInPandas: worst mean {worst}")

        def add_ratio(batches):
            for b in batches:
                b = b.copy()
                b["ratio"] = b["price"] / b["guest"]
                yield b

        with_ratio = df.map_in_pandas(
            add_ratio, "guest DOUBLE, price DOUBLE, ratio DOUBLE")
        if with_ratio.columns != ["guest", "price", "ratio"]:
            raise AssertionError("io tour mapInPandas")
        ran += ["applyInPandas", "mapInPandas"]
    else:
        skipped["applyInPandas"] = skipped["mapInPandas"] = "pandas"
    df.create_or_replace_temp_view("inv")
    if spark.table("inv").count() != n:
        raise AssertionError("io tour spark.table")
    spark.catalog.drop("inv")
    ran.append("table")
    return {"ran": ran, "skipped": skipped, "csv_read": rec}


def copy_times(frame) -> dict:
    """The streamed read's copies replayed alone: each column of ``frame``
    from a page-locked host buffer to the card on a side stream, timed
    with CUDA events (median of 5) -- the device time of the read's
    copies when the profiler records none."""
    import torch

    cols = [frame._column_values(c) for c in ("guest", "price")]
    host = [torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
            for c in cols]
    dev = [torch.empty_like(c) for c in cols]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())

    def run():
        with torch.cuda.stream(side):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for d, h in zip(dev, host):
                d.copy_(h, non_blocking=True)
            end.record()
        end.synchronize()
        return start.elapsed_time(end)

    ms = float(np.median([run() for _ in range(5)]))
    nbytes = sum(c.numel() * c.element_size() for c in cols)
    return {"bytes": nbytes, "ms": ms, "gb_s": nbytes / ms / 1e6}


def ingest_read(spark, path: str, engine: str = "native"):
    """The app's read (inferSchema, no header) and its two renames."""
    df = (spark.read.format("csv").option("inferSchema", "true")
          .option("engine", engine).load(path))
    return df.with_column_renamed("_c0", "guest").with_column_renamed(
        "_c1", "price")


def ingest_app(spark, path: str) -> dict:
    """File to predict(40): the read, the app path, its summary's RMSE and
    the fused DQ pass over the ingested columns (``run_full``'s result)."""
    from sparkdq4ml_tpu_torch.ops.rules import dq_rules_fused

    df = ingest_read(spark, path)
    out, model, pred = app_path(spark, df)
    rmse = model.summary.rootMeanSquaredError
    keep = dq_rules_fused(df.col("price").eval(df),
                          df.col("guest").eval(df))[2]
    return {"kept": out.count(), "fused_kept": int(keep.sum()),
            "coef": float(model.coefficients[0]),
            "intercept": model.intercept, "rmse": rmse, "predict40": pred}


def ingest_conf(key: str, value: str):
    """A context in which the session's ingest setting ``key``
    (``spark.ingest.*``) is ``value``; the old value comes back after."""
    import contextlib

    from sparkdq4ml_tpu_torch import TorchSession
    from sparkdq4ml_tpu_torch.config import INGEST_KEYS, config

    @contextlib.contextmanager
    def scope():
        old = getattr(config, INGEST_KEYS[key][0])
        TorchSession.builder().config(key, value).get_or_create()
        try:
            yield
        finally:
            TorchSession.builder().config(key, str(old)).get_or_create()

    return scope()


def same_columns(a, b, what: str, rows=None, price_dtype=None) -> None:
    """``guest`` (int32) and ``price`` (float32, or ``price_dtype``) of two
    frames on the card, bit for bit (``b``'s first ``rows`` rows when
    given; ``b`` may be a dict of tensors)."""
    import torch

    for c, dt in (("guest", torch.int32),
                  ("price", price_dtype or torch.float32)):
        x = a._column_values(c)
        y = b[c] if isinstance(b, dict) else b._column_values(c)
        y = y if rows is None else y[:rows]
        if x.dtype != dt or x.device.type != "cuda" or \
                y.dtype != dt or not same_bits(x, y):
            raise AssertionError(f"{what}: column {c} ({x.dtype}, "
                                 f"{x.device}) differs")


def against_oneshot(spark, path: str, mode: str, what: str,
                    price_dtype=None):
    """The streamed read of ``path``, which must take ``mode``, held bit for
    bit to the one-shot read of the same file under the policy in force;
    returns (the streamed frame, its read record)."""
    from sparkdq4ml_tpu_torch.frame import native_csv

    streamed = ingest_read(spark, path)
    rec = native_csv.reads.last()
    with ingest_conf("spark.ingest.streaming", "false"):
        oneshot = ingest_read(spark, path)
    one_rec = native_csv.reads.last()
    if rec["mode"] != mode or one_rec["mode"] != "oneshot":
        raise AssertionError(f"{what}: reads {rec}, {one_rec}")
    same_columns(streamed, oneshot, what, price_dtype=price_dtype)
    return streamed, rec


def check_ingest(full: dict, plain: dict, have: dict) -> dict:
    """Phase 10: the IO tour on dataset-full, then ingest at 10^7 rows: the
    streamed read of a headerless CSV of ``full_table`` into the app, held
    bit for bit to phase 5's input columns and its card result (``full``),
    and within 1e-3 to its CPU float64 result (``plain``); the one-shot,
    quoted, Python-engine and Parquet reads against it; the float64-policy
    streamed read and the quoted file in many chunks against their
    one-shot reads; times."""
    import math
    import shutil
    import tempfile

    import torch

    from sparkdq4ml_tpu_torch import functions as F
    from sparkdq4ml_tpu_torch.config import config, float_policy
    from sparkdq4ml_tpu_torch.frame import native_csv
    from sparkdq4ml_tpu_torch.ops import kernels

    spark = session("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    try:
        tour = tour_io(spark, F, tmp, have)
        log(f"io tour on dataset-full: ran {tour['ran']}, skipped "
            f"{tour['skipped']}")
        guest, price = full_table(FULL_ROWS)
        path = os.path.join(tmp, "full.csv")
        t0 = time.perf_counter()
        size = write_table_csv(path, guest, price)
        gen_s = time.perf_counter() - t0
        head = os.path.join(tmp, "head.csv")
        write_table_csv(head, guest[:PYTHON_ENGINE_ROWS],
                        price[:PYTHON_ENGINE_ROWS])
        log(f"ingest file: {FULL_ROWS} rows, {size} bytes, written in "
            f"{gen_s:.2f} s")
        ingest_app(spark, head)                             # warm-up

        # the streamed read (the file is in the page cache: parse and copy)
        read_s, records = [], []
        for _ in range(INGEST_RUNS):
            streamed, s = timed(lambda: ingest_read(spark, path))
            read_s.append(s)
            records.append(native_csv.reads.last())
        rec = records[-1]
        want_chunks = math.ceil(size / config.ingest_chunk_bytes)
        if any(r["mode"] != "pinned" or r["copies"] != "pinned"
               or r["chunks"] < want_chunks or r["rows"] != FULL_ROWS
               for r in records):
            raise AssertionError(f"the streamed read took another path: "
                                 f"{records}")
        same_columns(streamed, spark.createDataFrame(
            {"guest": guest, "price": price}), "streamed read against "
            "createDataFrame")
        prof = profile_run("ingest_read", lambda: ingest_read(spark, path))
        if prof["device_events"] == 0:
            # after the script's earlier profiler sessions, the first one
            # here has recorded no device event for the read: try once
            # more, and time the read's copies with CUDA events in any case
            prof = {"first_try": prof, **profile_run(
                "ingest_read", lambda: ingest_read(spark, path))}
        copies = copy_times(streamed)

        # the one-shot read
        oneshot_s = []
        with ingest_conf("spark.ingest.streaming", "false"):
            for _ in range(INGEST_RUNS):
                oneshot, s = timed(lambda: ingest_read(spark, path))
                oneshot_s.append(s)
        oneshot_rec = native_csv.reads.last()
        if oneshot_rec["mode"] != "oneshot":
            raise AssertionError(f"one-shot read: {oneshot_rec}")
        same_columns(oneshot, streamed, "one-shot read against streamed")
        del oneshot

        # the float64 policy: float64 rows copied chunk by chunk, held to
        # the one-shot read and to the columns the file was written from
        with float_policy(torch.float64):
            wide, wide_rec = against_oneshot(
                spark, path, "pinned", "float64 streamed read against "
                "one-shot", torch.float64)
        same_columns(wide, {"guest": torch.from_numpy(guest).cuda(),
                            "price": torch.from_numpy(price).cuda()},
                     "float64 streamed read against the written columns",
                     price_dtype=torch.float64)
        del wide

        # file to predict(40), the launch counts from the first run
        torch.cuda.synchronize()
        kernels.launches.reset()
        app, first = timed(lambda: ingest_app(spark, path))
        counts = kernels.launches.snapshot()
        app_s = [first] + [timed(lambda: ingest_app(spark, path))[1]
                           for _ in range(INGEST_RUNS - 1)]
        log(f"file to predict(40): {app}; launches {counts}")
        if any(counts[k] != 1 for k in APP_KERNELS):
            raise AssertionError(f"ingest app launches {counts}, expected "
                                 f"{APP_KERNELS} once each")
        if app != full:
            raise AssertionError(f"ingest app {app} != phase 5's card "
                                 f"result {full}")
        if app["kept"] != plain["kept"] or any(
                abs(app[k] - plain[k]) > 1e-3 * abs(plain[k])
                for k in ("coef", "intercept", "rmse", "predict40")):
            raise AssertionError(f"ingest app {app} against cpu float64 "
                                 f"{plain}")

        # a quoted copy of the first rows: the per-chunk body
        qpath = os.path.join(tmp, "quoted.csv")
        qsize = write_table_csv(qpath, guest[:QUOTED_ROWS],
                                price[:QUOTED_ROWS], quoted=True)
        quoted, quoted_s = timed(lambda: ingest_read(spark, qpath))
        quoted_rec = native_csv.reads.last()
        if quoted_rec["mode"] != "chunked":
            raise AssertionError(f"quoted read: {quoted_rec}")
        same_columns(quoted, streamed, "quoted read", rows=QUOTED_ROWS)
        del quoted
        # ... and cut into many chunks, under both policies
        quoted_many = {}
        with ingest_conf("spark.ingest.chunkBytes", str(QUOTED_CHUNK_BYTES)):
            for name, dt in (("float32", torch.float32),
                             ("float64", torch.float64)):
                with float_policy(dt):
                    _, rec_many = against_oneshot(
                        spark, qpath, "chunked", f"quoted read in many "
                        f"chunks against one-shot, {name}", dt)
                if rec_many["chunks"] < math.ceil(qsize / QUOTED_CHUNK_BYTES):
                    raise AssertionError(f"quoted read: {rec_many}")
                quoted_many[name] = rec_many

        # the Python engine against the native one
        py, py_s = timed(lambda: ingest_read(spark, head, engine="python"))
        py_rec = native_csv.reads.last()
        if py_rec["engine"] != "python":
            raise AssertionError(f"python engine read: {py_rec}")
        same_columns(py, ingest_read(spark, head), "python engine")
        del py

        parquet = None
        if have["pyarrow"]:
            pq_path = os.path.join(tmp, "full.parquet")
            _, write_s = timed(lambda: streamed.write.parquet(pq_path))
            back, pq_read_s = timed(lambda: spark.read.parquet(pq_path))
            same_columns(back, streamed, "parquet round trip")
            parquet = {"write_s": write_s, "read_s": pq_read_s,
                       "bytes": os.path.getsize(pq_path)}
            del back

        apply_s = None
        if have["pandas"]:
            apply_s = []
            for _ in range(INGEST_RUNS):
                demeaned, s = timed(lambda: streamed.group_by(
                    "guest").apply_in_pandas(demean_price,
                                             "guest DOUBLE, price DOUBLE"))
                apply_s.append(s)
            means = demeaned.group_by("guest").agg(
                F.avg("price").alias("m")).to_pydict()["m"]
            if demeaned.count() != FULL_ROWS or len(means) != 39 or \
                    float(np.max(np.abs(means))) >= TOUR_MEAN_ATOL:
                raise AssertionError("applyInPandas at 10^7 rows")
            del demeaned
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        spark.stop()
    med = float(np.median(read_s))
    out = {"rows": FULL_ROWS, "file_bytes": size, "file_write_s": gen_s,
           "chunk_bytes": config.ingest_chunk_bytes,
           "streamed_read_s": read_s, "streamed_read_median_s": med,
           "streamed_bytes_per_s": size / med,
           "streamed_rows_per_s": FULL_ROWS / med,
           "streamed_records": records, "streamed_profile": prof,
           "streamed_copies_replayed": copies,
           "oneshot_read_s": oneshot_s,
           "oneshot_read_median_s": float(np.median(oneshot_s)),
           "oneshot_record": oneshot_rec,
           "file_to_predict40_s": app_s,
           "file_to_predict40_median_s": float(np.median(app_s)),
           "app": app, "launches": counts,
           "float64_streamed_record": wide_rec,
           "quoted": {"rows": QUOTED_ROWS, "bytes": qsize, "s": quoted_s,
                      "record": quoted_rec, "many_chunks": quoted_many},
           "python_engine": {"rows": PYTHON_ENGINE_ROWS, "s": py_s,
                             "record": py_rec},
           "parquet": parquet, "apply_in_pandas_s": apply_s,
           "apply_in_pandas_median_s": (None if apply_s is None
                                        else float(np.median(apply_s))),
           "io_tour": tour,
           "page_cache": "the file is read right after it is written, so "
                         "the times are of parsing and copying, not of "
                         "the disk"}
    log(f"ingest at {FULL_ROWS} rows: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 11: a DQ report at 10^7 rows
# ---------------------------------------------------------------------------

# full_table(10^7) through the DQ rules: the rows dq_rules keeps and drops
REPORT_KEPT = 9_611_537
REPORT_REJECTED = 388_463
REPORT_QUANTILES = (0.01, 0.5, 0.99)
REPORT_FRACTION = 0.1
REPORT_WEIGHTS = (0.8, 0.2)
REPORT_SEED = 7
# The correlated step's inner filter: only rule 2's rejected rows (guests
# under 14) cost more, so EXISTS keeps a proper subset of the clean rows.
REPORT_DEAR = 90.0
# The steps the CPU float64 run repeats; the rejected rows and the
# correlated step are exact rows, held against numpy (report_rows_numpy).
REPORT_CPU_STEPS = ("profile", "per_guest", "subtotals", "sampling")
# The steps whose two card runs must agree bit for bit (fixed-order sums).
REPORT_STABLE = ("per_guest", "subtotals")
SKEW_RTOL = 1e-9               # skewness/kurtosis against numpy, float64


def report_tables(device: str, guest, price, rejected: bool = True):
    """A session, the raw table, the table cleaned by one ``dq_rules``
    launch (as ``clean_table``), phase 8's CASE band over the clean rows,
    and (with ``rejected``) the rejected rows, ``raw.except_all(clean)``,
    registered as raw, clean, banded and rejected."""
    from sparkdq4ml_tpu_torch.ops.rules import dq_rules_fused

    spark = session(device)
    raw = spark.createDataFrame({"guest": guest, "price": price})
    keep = dq_rules_fused(raw.col("price").eval(raw),
                          raw.col("guest").eval(raw))[2]
    clean = raw.filter(keep)
    raw.create_or_replace_temp_view("raw")
    clean.create_or_replace_temp_view("clean")
    banded = spark.sql(BAND_SQL)
    banded.create_or_replace_temp_view("banded")
    if rejected:
        raw.except_all(clean).create_or_replace_temp_view("rejected")
    return spark, {"raw": raw, "clean": clean, "banded": banded}


def report_steps(spark, t):
    """Phase 11's steps on ``report_tables``' frames, as (name, fn) pairs
    returning {name: frame or host value}: (1) the profile (describe,
    summary, corr, cov, quantiles, crosstab); (2) per-guest statistics
    (the order statistics, moments, a distinct count and a set of bands),
    and the median guest at each price; (3) subtotals: rollup, cube, the
    rollup through SQL, a pivot; (4) the rejected rows by set operations,
    frame and SQL; (5) correlated EXISTS / NOT EXISTS / IN, the first two
    also with an inner filter (r.price > REPORT_DEAR), and their explicit
    joins; (6) sampling."""
    from sparkdq4ml_tpu_torch import functions as F

    raw, clean, banded = t["raw"], t["clean"], t["banded"]

    def profile():
        return {"describe": clean.describe("guest", "price"),
                "summary": clean.summary(),
                "corr": {"pearson": clean.stat.corr("guest", "price"),
                         "spearman": clean.stat.corr("guest", "price",
                                                     "spearman"),
                         "cov": clean.stat.cov("guest", "price")},
                "quantiles": clean.stat.approx_quantile(
                    "price", list(REPORT_QUANTILES), 0.0),
                "crosstab": banded.stat.crosstab("guest", "band")}

    def per_guest():
        return {"by_guest": banded.group_by("guest").agg(
                    F.median("price"), F.percentile_approx("price", 0.9),
                    F.mode("price"), F.skewness("price"),
                    F.kurtosis("price"), F.count_distinct("price"),
                    F.collect_set("band")),
                "by_price": clean.group_by("price").agg(F.median("guest"))}

    def subtotals():
        aggs = [F.count(), F.sum("price"), F.avg("price")]
        return {"rollup": banded.rollup("band", "guest").agg(*aggs),
                "cube": banded.cube("band", "guest").agg(*aggs),
                "sql_rollup": spark.sql(
                    "SELECT band, guest, COUNT(*), SUM(price), AVG(price) "
                    "FROM banded GROUP BY ROLLUP(band, guest)"),
                "pivot": banded.group_by("guest").pivot("band").agg(
                    F.avg("price"), F.count())}

    def rejected():
        return {"except_all": raw.except_all(clean),
                "intersect_all": raw.intersect_all(clean),
                "subtract": raw.subtract(clean),
                "intersect": raw.intersect(clean),
                "clean_distinct": clean.distinct(),
                "raw_distinct": raw.distinct(),
                "sql_except": spark.sql("SELECT guest, price FROM raw EXCEPT "
                                        "SELECT guest, price FROM clean"),
                "sql_union": spark.sql("SELECT guest, price FROM raw UNION "
                                       "SELECT guest, price FROM clean")}

    def correlated():
        sub = "(SELECT 1 FROM rejected r WHERE r.guest = c.guest)"
        dear = ("(SELECT 1 FROM rejected r WHERE r.guest = c.guest AND "
                f"r.price > {REPORT_DEAR})")
        dear_guests = (f"(SELECT guest FROM rejected WHERE price > "
                       f"{REPORT_DEAR}) d")
        return {"exists": spark.sql("SELECT c.guest, c.price FROM clean c "
                                    f"WHERE EXISTS {sub}"),
                "semi": spark.sql("SELECT guest, price FROM clean LEFT SEMI "
                                  "JOIN rejected USING (guest)"),
                "not_exists": spark.sql("SELECT c.guest, c.price FROM clean "
                                        f"c WHERE NOT EXISTS {sub}"),
                "anti": spark.sql("SELECT guest, price FROM clean LEFT ANTI "
                                  "JOIN rejected USING (guest)"),
                "in_pairs": spark.sql(
                    "SELECT c.guest, c.price FROM clean c WHERE c.price IN "
                    "(SELECT r.price FROM rejected r WHERE r.guest = "
                    "c.guest)"),
                "semi_pairs": spark.sql(
                    "SELECT guest, price FROM clean LEFT SEMI JOIN rejected "
                    "USING (guest, price)"),
                "exists_dear": spark.sql("SELECT c.guest, c.price FROM "
                                         f"clean c WHERE EXISTS {dear}"),
                "semi_dear": spark.sql("SELECT guest, price FROM clean LEFT "
                                       f"SEMI JOIN {dear_guests} USING "
                                       "(guest)"),
                "not_exists_dear": spark.sql(
                    "SELECT c.guest, c.price FROM clean c WHERE NOT EXISTS "
                    f"{dear}"),
                "anti_dear": spark.sql("SELECT guest, price FROM clean LEFT "
                                       f"ANTI JOIN {dear_guests} USING "
                                       "(guest)")}

    def sampling():
        parts = clean.random_split(list(REPORT_WEIGHTS), seed=REPORT_SEED)
        return {"sample": clean.sample(REPORT_FRACTION, seed=REPORT_SEED),
                **{f"split{i}": p for i, p in enumerate(parts)}}

    return [("profile", profile), ("per_guest", per_guest),
            ("subtotals", subtotals), ("rejected", rejected),
            ("correlated", correlated), ("sampling", sampling)]


def run_report(spark, tables, times=None, runs: int = 1, names=None):
    """Phase 11's steps (those in ``names``, all by default): {step: [each
    run's results]}."""
    steps = [(name, fn) for name, fn in report_steps(spark, tables)
             if names is None or name in names]
    return run_steps(steps, spark.device.type, times, runs)


def summarize_report(res: dict) -> dict:
    """Host arrays of every step's results: a frame's columns (numeric as
    float64, strings and lists as object arrays) and its mask, a number
    as a 1-element float64 array."""
    out = {}
    for step, results in res.items():
        for name, value in results.items():
            key = f"{step}.{name}"
            if isinstance(value, dict):
                out[key] = {k: np.asarray([v], np.float64)
                            for k, v in value.items()}
            elif isinstance(value, list):
                out[key] = {"values": np.asarray(value, np.float64)}
            else:
                d = value.to_pydict()
                cols = {c: v if v.dtype == object else np.asarray(v,
                                                                  np.float64)
                        for c, v in d.items()}
                cols["__mask__"] = value.mask.cpu().numpy().astype(
                    np.float64)
                out[key] = cols
    return out


# What each report column is held to against the CPU float64 run: the
# statistics computed from sums "rtol" (SQL_ROWS_RTOL), the medians and
# the summary's interpolated percentiles "near" (REPORT_NEAR_RTOL: the
# card averages two float32 picks where the CPU averages two float64
# ones; held exactly against numpy on the card's own values instead);
# everything else exact, a float64 value rounded to float32 first.
REPORT_RTOL_COLS = {"sum(price)", "avg(price)", "pearson", "spearman",
                    "cov"}
REPORT_NEAR_RTOL = 1e-6
# Skewness and excess kurtosis are near 0 for the guests without outliers,
# so they are held absolutely: float32 prices move them by up to 3e-5
# from their float64 values at 10^6 rows of full_table; the tight check
# is against numpy on the card's own values (check_report_numpy).
REPORT_MOMENT_COLS = {"skewness(price)", "kurtosis(price)"}
REPORT_MOMENT_ATOL = 1e-4


def _pivot_sums(name: str) -> bool:
    return name.endswith("_avg(price)")


def check_report(card: dict, cpu: dict) -> dict:
    """The card's float32 report against the CPU float64 run of the same
    code. describe/summary cells are strings: counts, minima and maxima
    equal to the CPU's values formatted as float32 scalars; means and
    stddevs parsed and within SQL_ROWS_RTOL; percentiles within
    REPORT_NEAR_RTOL. Returns the largest relative error of each
    tolerance column."""
    errs = {}
    for key, want in cpu.items():
        got = card[key]
        if list(got) != list(want):
            raise AssertionError(f"{key}: columns {list(got)} vs "
                                 f"{list(want)}")
        strings_ = key.endswith((".describe", ".summary"))
        for c, w in want.items():
            g = got[c]
            where = f"{key}.{c}"
            if g.shape != w.shape:
                raise AssertionError(f"{where}: {g.shape} vs {w.shape}")
            if strings_ and c not in ("summary", "__mask__"):
                stats = want["summary"].tolist()
                for s, a, b in zip(stats, g.tolist(), w.tolist()):
                    if s in ("mean", "stddev") or s.endswith("%"):
                        tol = (SQL_ROWS_RTOL if s in ("mean", "stddev")
                               else REPORT_NEAR_RTOL)
                        rel = abs(float(a) - float(b)) / abs(float(b))
                        errs[f"{where}.{s}"] = rel
                        if rel > tol:
                            raise AssertionError(f"{where}.{s}: {a} vs {b}")
                    elif a != (b if s == "count" or c == "guest"
                               else str(np.float32(float(b)))):
                        raise AssertionError(f"{where}.{s}: {a} vs {b}")
                continue
            if g.dtype == object or w.dtype == object:
                if not (g.dtype == w.dtype and all(
                        x == y for x, y in zip(g.tolist(), w.tolist()))):
                    raise AssertionError(f"{where}: cells differ")
                continue
            if c in REPORT_MOMENT_COLS:
                errs[where] = float(np.max(np.abs(g - w)))
                if not errs[where] <= REPORT_MOMENT_ATOL:
                    raise AssertionError(f"{where}: max absolute error "
                                         f"{errs[where]}")
                continue
            near = c.startswith("median(")
            if c in REPORT_RTOL_COLS or near or _pivot_sums(c):
                tol = REPORT_NEAR_RTOL if near else SQL_ROWS_RTOL
                ok = np.isnan(w) == np.isnan(g)
                rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-30)
                rel = np.where(np.isnan(w), 0.0, rel)
                errs[where] = float(rel.max()) if rel.size else 0.0
                if not ok.all() or errs[where] > tol:
                    raise AssertionError(f"{where}: max relative error "
                                         f"{errs[where]} > {tol}")
                continue
            w32 = w.astype(np.float32).astype(np.float64)
            if not np.array_equal(g, w32, equal_nan=True):
                bad = int((~((g == w32) | (np.isnan(g) & np.isnan(w32)))
                           ).sum())
                raise AssertionError(f"{where}: {bad} values differ")
    return errs


def _rows(frame) -> np.ndarray:
    """A (guest, price) frame's valid rows as one sorted structured
    array, for comparing row sets."""
    d = frame.to_pydict()
    rows = np.empty(len(d["guest"]), dtype=[("g", "f8"), ("p", "f8")])
    rows["g"], rows["p"] = d["guest"], d["price"]
    return np.sort(rows)


def check_report_identities(res: dict, clean, kept: int = REPORT_KEPT,
                            rejected: int = REPORT_REJECTED) -> dict:
    """The identities the rules make true whatever the implementation
    (each rule is a function of the (guest, price) pair): the rejected
    rows, the kept rows, the distinct rejected pairs, and the SQL forms;
    each correlated query equal to its explicit join bit for bit."""
    rej, cor = res["rejected"], res["correlated"]
    counts = {k: f.count() for k, f in rej.items()}
    if counts["except_all"] != rejected:
        raise AssertionError(f"raw EXCEPT ALL clean: {counts['except_all']}"
                             f" rows, expected {rejected}")
    if counts["intersect_all"] != kept:
        raise AssertionError(f"raw INTERSECT ALL clean: "
                             f"{counts['intersect_all']} rows, expected "
                             f"{kept}")
    if rej["subtract"].intersect(clean).count() != 0:
        raise AssertionError("a row of raw.subtract(clean) is in clean")
    pairs = {"subtract = distinct rejected rows":
             (rej["subtract"], rej["except_all"].distinct()),
             "intersect = clean.distinct()":
             (rej["intersect"], rej["clean_distinct"]),
             "SQL EXCEPT = subtract": (rej["sql_except"], rej["subtract"]),
             "SQL UNION = raw.distinct()": (rej["sql_union"],
                                            rej["raw_distinct"])}
    for what, (a, b) in pairs.items():
        if not np.array_equal(_rows(a), _rows(b)):
            raise AssertionError(f"{what}: the row sets differ")
    same = {}
    for q, join in (("exists", "semi"), ("not_exists", "anti"),
                    ("in_pairs", "semi_pairs"), ("exists_dear", "semi_dear"),
                    ("not_exists_dear", "anti_dear")):
        a, b = cor[q].to_pydict(), cor[join].to_pydict()
        if list(a) != list(b) or not all(
                np.array_equal(a[c].view(np.uint8), b[c].view(np.uint8))
                for c in a):
            raise AssertionError(f"correlated {q} differs from LEFT "
                                 f"{join.upper()} JOIN")
        same[q] = len(a["guest"])
    if same["in_pairs"] != 0:
        raise AssertionError("a clean (guest, price) pair is a rejected one")
    if not 0 < same["exists_dear"] < kept or \
            same["exists_dear"] + same["not_exists_dear"] != kept:
        raise AssertionError(f"EXISTS with r.price > {REPORT_DEAR}: "
                             f"{same['exists_dear']} of {kept} rows, not a "
                             "proper subset, or NOT EXISTS does not "
                             "complement it")
    return {"counts": counts, "correlated_rows": same}


def report_rows_numpy(tables) -> dict:
    """Steps 4 and 5 by numpy alone, from the raw table's columns and the
    clean table's mask (the rows dq_rules keeps): {"step.name": (guest,
    price)} of each result's rows, in order. A row's key is its pair of
    per-column ranks (np.unique: every NaN one value, -0.0 equal to 0.0),
    dense, so one stable sort of the keys gives every count. The set
    operations keep the left side's first-appearance order and spend the
    right side's count of a key on its earliest left rows (clean is a
    filter of raw, so UNION's rows are raw's first appearances); the
    correlated queries keep the clean rows whose guest (or pair) a
    rejected row has, in clean order."""
    d = tables["raw"].to_pydict()
    g, p = d["guest"].astype(np.float64), d["price"].astype(np.float64)
    keep = tables["clean"].mask.cpu().numpy()
    n = g.size
    if keep.shape != (n,):
        raise AssertionError("the clean mask does not cover the raw rows")
    guests, g_code = np.unique(g, return_inverse=True)
    prices, p_code = np.unique(p, return_inverse=True)
    size = guests.size * prices.size
    key = g_code.reshape(-1).astype(np.int64) * prices.size + p_code
    order = np.argsort(key, kind="stable")
    per_key = np.bincount(key, minlength=size)
    before = np.cumsum(per_key) - per_key
    occ = np.empty(n, np.int64)
    occ[order] = np.arange(n) - np.repeat(before, per_key)
    budget = np.bincount(key[keep], minlength=size)[key]
    # each key's first kept row: the first of its run among the kept rows
    # in key order
    kept = order[keep[order]]
    runs = np.ones(kept.size, bool)
    runs[1:] = key[kept][1:] != key[kept][:-1]
    clean_first = np.zeros(n, bool)
    clean_first[kept[runs]] = True
    rej = occ >= budget
    out = {f"rejected.{k}": (g[sel], p[sel]) for k, sel in (
        ("except_all", rej), ("intersect_all", ~rej),
        ("subtract", (occ == 0) & (budget == 0)),
        ("intersect", (occ == 0) & (budget > 0)),
        ("clean_distinct", clean_first), ("raw_distinct", occ == 0),
        ("sql_except", (occ == 0) & (budget == 0)),
        ("sql_union", occ == 0))}

    def has(codes, where, width):
        hit = np.zeros(width, bool)
        hit[codes[where]] = True
        return hit[codes[keep]]

    by_guest = has(g_code.reshape(-1), rej, guests.size)
    by_dear = has(g_code.reshape(-1), rej & (p > REPORT_DEAR), guests.size)
    by_pair = has(key, rej, size)
    for k, sel in (("exists", by_guest), ("semi", by_guest),
                   ("not_exists", ~by_guest), ("anti", ~by_guest),
                   ("in_pairs", by_pair), ("semi_pairs", by_pair),
                   ("exists_dear", by_dear), ("semi_dear", by_dear),
                   ("not_exists_dear", ~by_dear),
                   ("anti_dear", ~by_dear)):
        out[f"correlated.{k}"] = (g[keep][sel], p[keep][sel])
    return out


def check_report_rows(res: dict, tables) -> dict:
    """Steps 4 and 5's results equal numpy's rows (report_rows_numpy),
    in order and exactly. Returns each result's row count."""
    rows = {}
    for key, (want_g, want_p) in report_rows_numpy(tables).items():
        step, name = key.split(".")
        d = res[step][name].to_pydict()
        got_g, got_p = (d["guest"].astype(np.float64),
                        d["price"].astype(np.float64))
        if not (np.array_equal(got_g, want_g)
                and np.array_equal(got_p, want_p)):
            raise AssertionError(f"{key}: {got_g.size} rows differ from "
                                 f"numpy's {want_g.size}")
        rows[key] = int(got_g.size)
    return rows


def check_report_numpy(res: dict, clean) -> dict:
    """The order statistics against numpy directly, on the card's own
    float32 values (as float64): per guest np.median, the nearest-rank
    percentile and the mode over np.lexsort; the median guest per price;
    approxQuantile and summary's percentiles (np.quantile); skewness and
    kurtosis by their numpy formulas within SKEW_RTOL and one rounding
    to the column's type (the JAX package's float32 column); the sample
    and split masks equal to numpy's draw."""
    d = clean.to_pydict()
    g, p = d["guest"].astype(np.float64), d["price"].astype(np.float64)
    by = res["per_guest"]["by_guest"].to_pydict()
    order = np.lexsort((p, g))
    gs, ps = g[order], p[order]
    starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
    groups = np.split(ps, starts[1:])
    want = {"median(price)": [], "percentile_approx(price, 0.9)": [],
            "mode(price)": [], "skewness(price)": [], "kurtosis(price)": []}
    for v in groups:
        want["median(price)"].append(np.median(v))
        want["percentile_approx(price, 0.9)"].append(
            v[max(int(np.ceil(0.9 * len(v))) - 1, 0)])
        u, c = np.unique(v, return_counts=True)
        want["mode(price)"].append(u[np.lexsort((u, -c))[0]])
        dv = v - v.mean()
        m2 = np.mean(dv ** 2)
        want["skewness(price)"].append(np.mean(dv ** 3) / m2 ** 1.5)
        want["kurtosis(price)"].append(np.mean(dv ** 4) / m2 ** 2 - 3.0)
    if not np.array_equal(by["guest"].astype(np.float64), gs[starts]):
        raise AssertionError("per-guest keys differ from numpy's")
    errs = {}
    for c, w in want.items():
        # the column's type is the JAX package's host-path one: float64
        # answers stored in the policy's float dtype
        got, w = by[c], np.asarray(w).astype(by[c].dtype)
        if c.startswith(("skewness", "kurtosis")):
            # float64 moments, one rounding to the column's type apart
            tol = SKEW_RTOL + float(np.finfo(got.dtype).eps) / 2
            errs[c] = float(np.max(np.abs(got.astype(np.float64) - w)
                                   / np.abs(w)))
            if errs[c] > tol:
                raise AssertionError(f"{c}: {errs[c]} from numpy")
        elif not np.array_equal(got, w):
            raise AssertionError(f"{c} differs from numpy")
    bp = res["per_guest"]["by_price"].to_pydict()
    order = np.lexsort((g, p))
    ps, gs = p[order], g[order]
    starts = np.flatnonzero(np.r_[True, ps[1:] != ps[:-1]])
    med = np.asarray([np.median(v) for v in np.split(gs, starts[1:])])
    if not (np.array_equal(bp["price"].astype(np.float64), ps[starts])
            and np.array_equal(bp["median(guest)"],
                               med.astype(bp["median(guest)"].dtype))):
        raise AssertionError("median(guest) by price differs from numpy")
    sp = np.sort(p)
    qs = [sp[min(int(q * sp.size), sp.size - 1)] for q in REPORT_QUANTILES]
    if res["profile"]["quantiles"] != qs:
        raise AssertionError("approxQuantile differs from numpy")
    summ = res["profile"]["summary"].to_pydict()
    for c, vals in (("guest", g), ("price", p)):
        for s, cell in zip(summ["summary"], summ[c]):
            if s.endswith("%") and cell != str(np.quantile(
                    vals, float(s[:-1]) / 100.0)):
                raise AssertionError(f"summary {c} {s}: {cell}")
    u = np.random.default_rng(REPORT_SEED).random(clean.num_slots)
    m = clean.mask.cpu().numpy()
    masks = {"sample": m & (u < REPORT_FRACTION)}
    edges = np.cumsum(np.asarray(REPORT_WEIGHTS) / sum(REPORT_WEIGHTS))
    lo = 0.0
    for i, hi in enumerate(edges):
        masks[f"split{i}"] = m & (u >= lo) & (u < hi)
        lo = hi
    for k, want_mask in masks.items():
        if not np.array_equal(res["sampling"][k].mask.cpu().numpy(),
                              want_mask):
            raise AssertionError(f"{k} mask differs from numpy's draw")
    split_rows = [res["sampling"][f"split{i}"].count()
                  for i in range(len(REPORT_WEIGHTS))]
    if sum(split_rows) != clean.count():
        raise AssertionError(f"split rows {split_rows} do not add up")
    return {"moments_vs_numpy": errs, "split_rows": split_rows,
            "sample_rows": int(masks["sample"].sum())}


def report_reference(guest, price) -> dict:
    """The CPU float64 run of phase 11's REPORT_CPU_STEPS (each once): its
    summary."""
    import torch

    from sparkdq4ml_tpu_torch.config import float_policy

    with float_policy(torch.float64):
        spark, tables = report_tables("cpu", guest, price, rejected=False)
        out = summarize_report(first_runs(run_report(
            spark, tables, names=REPORT_CPU_STEPS)))
        spark.stop()
    return out


def check_report_full(guest, price, reference=None) -> dict:
    """Phase 11 on the 10^7-row table: the CPU float64 run of
    REPORT_CPU_STEPS (from ``reference``'s worker when given, else run
    here), then the card (float32) with the launch counts set
    to 0 just before the table is cleaned and read just after the steps
    (dq_rules once, both segment sums at least once); every step's median
    of 3 host-clock times, and one more run under torch.profiler for the
    device's idle share; steps 2 and 3 bit-identical over two runs; the
    rules' identities; the order statistics, the sampling masks and the
    rows of steps 4 and 5 against numpy; the other steps' results against
    the CPU run."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    if reference is None:
        t0 = time.perf_counter()
        cpu = report_reference(guest, price)
        cpu_s = time.perf_counter() - t0
    else:
        cpu, timing = reference.result("report")
        cpu_s = timing["reference_s"]
        log(f"phase 11's cpu float64 reference: {timing}")
    spark, tables = report_tables("cuda", guest[:1000], price[:1000])
    run_report(spark, tables)                               # warm-up
    spark.stop()
    times: dict = {}
    torch.cuda.synchronize()
    kernels.launches.reset()
    t0 = time.perf_counter()
    spark, tables = report_tables("cuda", guest, price)
    outs = run_report(spark, tables, times, runs=3)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = kernels.launches.snapshot()
    if counts["dq_rules"] != 1:
        raise AssertionError(f"the DQ report launched dq_rules "
                             f"{counts['dq_rules']} times, expected 1")
    for name in ("dense_segment_sum", "sorted_segment_sum"):
        if counts[name] == 0:
            raise AssertionError(f"the DQ report never launched {name}")
    prof = profile_run("dq_report", lambda: run_report(spark, tables))
    first = first_runs(outs)
    card = summarize_report(first)
    again = summarize_report({k: outs[k][1] for k in REPORT_STABLE})
    unstable = bit_identical({k: card[k] for k in again}, again)
    if unstable:
        raise AssertionError(f"steps 2-3 differ between two card runs: "
                             f"{unstable}")
    identities = check_report_identities(first, tables["clean"])
    numpy_checks = check_report_numpy(first, tables["clean"])
    t0 = time.perf_counter()
    numpy_rows = check_report_rows(first, tables)
    numpy_rows_s = time.perf_counter() - t0
    kept = tables["clean"].count()
    spark.stop()
    if kept != REPORT_KEPT:
        raise AssertionError(f"clean rows: {kept}, expected {REPORT_KEPT}")
    if bit_identical({"x": card["subtotals.rollup"]},
                     {"x": card["subtotals.sql_rollup"]}):
        raise AssertionError("SQL ROLLUP differs from rollup()")
    errs = check_report(card, cpu)
    steps_ms = {k: 1e3 * float(np.median(v)) for k, v in times.items()}
    log(f"DQ report at {len(guest)} rows ({kept} clean), card float32: "
        f"step ms (median) {steps_ms}; runs s {times}; launches {counts}; "
        f"identities {identities}; numpy {numpy_checks}; steps 4-5 rows "
        f"equal to numpy's {numpy_rows} ({numpy_rows_s:.1f} s); steps 2-3 "
        f"bit-identical over two runs; profile {prof}; cpu float64 "
        f"reference {cpu_s:.1f} s; errors against cpu float64 {errs}")
    return {"rows": len(guest), "clean_rows": kept, "steps_ms": steps_ms,
            "runs_s": times, "path_s": path_s, "launches": counts,
            "identities": identities, "numpy": numpy_checks,
            "numpy_rows": numpy_rows, "numpy_rows_s": numpy_rows_s,
            "profile": prof, "cpu_reference_s": cpu_s, "max_rel_err": errs}


# ---------------------------------------------------------------------------
# Phase 12: the builtin function library at 10^7 rows
# ---------------------------------------------------------------------------

BUILTIN_HEAD = 1_000_000        # the string step's rows
BUILTIN_SMALL = 100_000         # the array, hash and JSON steps' rows
BUILTIN_SEED = 42
# A NaN-holed copy of price: every seventh guest is NULL.
HOLED = "CASE WHEN guest % 7 = 0 THEN NULL ELSE price END"
# The step-1 columns computed by transcendental functions: held within
# BUILTIN_RTOL to the CPU float64 run on the same (float32) prices; every
# other column of every step is held to the CPU run in the same policy bit
# for bit.
BUILTIN_TRANSCENDENTAL = ("l1p", "sq", "cb", "pw", "hy", "at2")
BUILTIN_RTOL = 2e-6
NUMERIC_SQL = ("guest", "price", "holed", "round(price, 1) AS r1",
               "bround(price, 1) AS b1", "floor(price) AS fl",
               "ceil(price) AS ce", "log1p(price) AS l1p",
               "sqrt(price) AS sq", "cbrt(price - 100) AS cb",
               "pow(guest, 2) AS pw", "hypot(guest, price) AS hy",
               "pmod(guest, 7) AS pm", "sign(price - 100) AS sg",
               "greatest(holed, guest) AS gr", "least(holed, guest) AS le",
               "coalesce(holed, price) AS co", "nanvl(holed, -1.0) AS nv",
               "atan2(price, guest) AS at2")
DAY0 = "(SELECT to_date('2019-01-01'))"
DATE_SQL = (f"SELECT guest, price, d, year(d) AS y, month(d) AS m, "
            "dayofmonth(d) AS dm, dayofweek(d) AS dw, dayofyear(d) AS dy, "
            "weekofyear(d) AS wk, quarter(d) AS q, last_day(d) AS ld, "
            "add_months(d, 1) AS am, months_between(d, "
            f"{DAY0}) AS mb, trunc(d, 'MM') AS tr, datediff(d, {DAY0}) "
            "AS dd, date_format(d, 'yyyy-MM-dd') AS ds, date_add(d, 30) AS "
            "da, date_sub(d, 30) AS dsub FROM dated")
STRING_SQL = ("SELECT upper(band) AS up, initcap(band) AS ic, lpad(ps, 8, "
              "'0') AS lp, trim(concat('  ', band, ' ')) AS tr, "
              "substring(ps, 1, 3) AS sb, regexp_replace(ps, '\\.', ',') AS "
              "rr, regexp_extract(ps, '(\\d+)\\.(\\d+)', 2) AS rx, band || "
              "'-' || ps AS cc, length(ps) AS ln, instr(ps, '.') AS ix, "
              "translate(band, 'aeiou', 'AEIOU') AS tl, levenshtein(band, ps) "
              "AS lv, md5(ps) AS m5, sha2(band, 256) AS s2, soundex(band) AS "
              "sx FROM {view}")
TIMESTAMP_SQL = ("SELECT ts, to_timestamp(ts) AS t1, unix_timestamp(ts) AS "
                 "u1, from_unixtime(unix_timestamp(ts)) AS f1, "
                 "hour(to_timestamp(ts)) AS hh, minute(ts) AS mi, "
                 "second(to_timestamp(ts)) AS ss, date_trunc('hour', ts) AS "
                 "dt FROM (SELECT concat(date_format((SELECT "
                 "to_date('2019-01-01')) + guest * 7 + CAST(price AS int), "
                 "'yyyy-MM-dd'), ' ', lpad(CAST(CAST(pmod(guest, 24) AS int) "
                 "AS string), 2, '0'), ':30:15') AS ts, guest FROM stamped)")
# The JAX package's hashes of the first 10^5 clean rows of full_table(10^7)
# on the CPU with x64 off (price as float32, as on the card);
# tests/test_torch_sql_builtins.py recomputes them.
BUILTIN_HASH_GOLDEN = {
    "rows": 100_000,
    "hash_sum": -778160241222,
    "hash_head": [1826934249, -1194975240, 488667980, -1494746737,
                  259964254],
    "xxhash64_sum_mod64": 14168691286192981976,
    "crc32_sum": 231034571660311,
}


def builtin_tables(device: str, guest, price):
    """A session, the table cleaned by one ``dq_rules`` launch (as
    ``clean_table``), phase 8's CASE band over it (``banded``), and the
    band's slots up to its 10^6-th and 10^5-th valid rows (``head``,
    ``small``), each registered under its name."""
    spark, clean = clean_table(device, guest, price)
    banded = spark.sql(BAND_SQL)
    tables = {"clean": clean, "banded": banded,
              "head": head_of(banded, BUILTIN_HEAD),
              "small": head_of(banded, BUILTIN_SMALL)}
    for name, frame in tables.items():
        frame.create_or_replace_temp_view(name)
    return spark, tables


def builtin_steps(spark, t):
    """Phase 12's steps on ``builtin_tables``' frames, as (name, fn) pairs
    returning {name: frame or host value}: (1) the numeric builtins on
    every clean row, fluent and as selectExpr; (2) dates on every clean
    row, and ``to_date`` of the 10^6-row head's date strings; (3) the
    string builtins on the head; (4) arrays, the higher-order functions
    and the generators on 10^5 rows; (5) hashes and JSON on 10^5 rows;
    (6) the row functions on every slot and a SELECT without FROM."""
    from sparkdq4ml_tpu_torch import functions as F

    banded, head, small = t["banded"], t["head"], t["small"]
    holed = banded.with_column("holed", F.expr(HOLED))

    def numeric():
        fluent = holed.select(
            "guest", "price", "holed", F.round("price", 1).alias("r1"),
            F.bround("price", 1).alias("b1"), F.floor("price").alias("fl"),
            F.ceil("price").alias("ce"), F.log1p("price").alias("l1p"),
            F.sqrt("price").alias("sq"),
            F.cbrt(F.col("price") - 100).alias("cb"),
            F.pow("guest", 2).alias("pw"), F.hypot("guest", "price").alias(
                "hy"), F.expr("pmod(guest, 7)").alias("pm"),
            F.signum(F.col("price") - 100).alias("sg"),
            F.greatest("holed", "guest").alias("gr"),
            F.least("holed", "guest").alias("le"),
            F.coalesce("holed", "price").alias("co"),
            F.nanvl("holed", F.lit(-1.0)).alias("nv"),
            F.atan2("price", "guest").alias("at2"))
        return {"fluent": fluent, "sql": holed.select_expr(*NUMERIC_SQL)}

    def dates():
        spark.sql(f"SELECT guest, price, {DAY0} + guest * 7 + CAST(price AS "
                  "int) AS d FROM banded").create_or_replace_temp_view(
                      "dated")
        fields = spark.sql(DATE_SQL)
        parsed = head_of(fields, BUILTIN_HEAD).select(
            "d", F.to_date("ds").alias("back"))
        return {"fields": fields, "parsed": parsed}

    def strings():
        head.select_expr("guest", "band", "CAST(price AS string) AS ps"
                         ).create_or_replace_temp_view("hs")
        return {"text": spark.sql(STRING_SQL.format(view="hs"))}

    def arrays():
        arr = spark.sql(
            "SELECT guest, price, band, sequence(1, guest % 5 + 1) AS seq, "
            "split(concat_ws(',', band, CAST(guest AS string), CAST(price "
            "AS string)), ',') AS parts FROM small")
        arr.create_or_replace_temp_view("arr")
        return {"ops": spark.sql(
                    "SELECT transform(seq, x -> x * price) AS tx, "
                    "filter(seq, x -> x % 2 = 1) AS fo, exists(seq, x -> x > "
                    "3) AS ex, aggregate(seq, 0, (acc, x) -> acc + x) AS ag, "
                    "array_union(seq, sequence(2, 4)) AS au, "
                    "array_intersect(seq, sequence(2, 4)) AS ai, "
                    "array_except(seq, sequence(2, 4)) AS ae, "
                    "array_join(parts, '|') AS aj, sort_array(parts) AS sa, "
                    "size(seq) AS sz FROM arr"),
                "posexploded": arr.select("guest", F.posexplode("seq")),
                "exploded": arr.select("guest", F.explode("seq")),
                "parts": arr.select("band", F.explode("parts"))}

    def hashes():
        hj = spark.sql(
            "SELECT hash(guest, price) AS h, xxhash64(band) AS xh, "
            "crc32(band) AS cr, concat('{\"guest\": ', CAST(guest AS "
            "string), ', \"band\": \"', band, '\", \"p\": [', CAST(price AS "
            "string), ']}') AS js FROM small")
        hj.create_or_replace_temp_view("hj")
        return {"hashes": hj,
                "json": spark.sql("SELECT get_json_object(js, '$.band') AS "
                                  "jb, get_json_object(js, '$.p[0]') AS jp "
                                  "FROM hj"),
                "tuple": hj.select(F.json_tuple("js", "guest", "band"))}

    def row_functions():
        return {"drawn": t["clean"].select(
                    F.rand(BUILTIN_SEED).alias("r"),
                    F.randn(BUILTIN_SEED).alias("n"),
                    F.monotonically_increasing_id().alias("id")),
                "by_name": spark.sql(f"SELECT rand({BUILTIN_SEED}) AS r, "
                                     f"randn({BUILTIN_SEED}) AS n FROM clean"),
                "one_row": spark.sql("SELECT 1 + 1, upper('a'), "
                                     "if(true, 1, 0)")}

    return [("numeric", numeric), ("dates", dates), ("strings", strings),
            ("arrays", arrays), ("hashes", hashes),
            ("row_functions", row_functions)]


def run_builtins(spark, tables, times=None, runs: int = 1, names=None):
    """Phase 12's steps (those in ``names``, all by default): {step: [each
    run's results]}."""
    steps = [(name, fn) for name, fn in builtin_steps(spark, tables)
             if names is None or name in names]
    return run_steps(steps, spark.device.type, times, runs)


def _cell(x):
    """A host cell as comparable data: arrays element by element, numbers
    by type and value (NaN as a token)."""
    if x is None:
        return None
    if isinstance(x, (list, tuple, np.ndarray)):
        return tuple(_cell(e) for e in x)
    if isinstance(x, (float, np.floating)):
        return (type(x).__name__, "nan" if np.isnan(x) else float(x))
    return (type(x).__name__, x)


def _cells(v) -> list:
    """A host column as a list of ``_cell``s; a column of strings and
    ``None`` compares as it is."""
    out = v.tolist()
    if set(map(type, out)) <= {str, type(None)}:
        return out
    return [_cell(x) for x in out]


def summarize_builtins(res: dict) -> dict:
    """{step.name: {column: host values}} of every step's frames, the
    mask as ``__mask__``: numeric columns as numpy arrays of their own
    dtype, host columns as lists of ``_cell``s."""
    out = {}
    for step, results in res.items():
        for name, frame in results.items():
            cols = {}
            for c, v in frame.to_pydict().items():
                cols[c] = _cells(v) if v.dtype == object else np.asarray(v)
            cols["__mask__"] = frame.mask.cpu().numpy()
            out[f"{step}.{name}"] = cols
    return out


def same_column(a, b) -> bool:
    """Bit for bit: numeric columns of one dtype with equal bits, host
    columns cell for cell."""
    if isinstance(a, list) or isinstance(b, list):
        return a == b
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        return np.array_equal(a.view(f"i{a.itemsize}"),
                              b.view(f"i{b.itemsize}"))
    return np.array_equal(a, b)


def differing(got: dict, want: dict) -> list:
    """The columns of two summaries of one frame that are not
    ``same_column``."""
    if list(got) != list(want):
        return ["columns"]
    return [c for c in want if not same_column(got[c], want[c])]


def check_builtins(card: dict, cpu32: dict, cpu64: dict) -> dict:
    """The card's float32 phase 12 against the CPU: every column bit for
    bit against the CPU float32 run of the same code, but the
    transcendental ones (BUILTIN_TRANSCENDENTAL, sqrt among them: the
    card's float32 sqrt is not the CPU's correctly rounded one), held
    within BUILTIN_RTOL of the CPU float64 run. Every column is checked
    before it raises, naming all that fail. Returns the transcendental
    columns' largest relative errors."""
    errs, bad = {}, []
    for key, want in cpu32.items():
        got = card[key]
        if list(got) != list(want):
            raise AssertionError(f"{key}: columns {list(got)} vs "
                                 f"{list(want)}")
        for c, w in want.items():
            where = f"{key}.{c}"
            if key.startswith("numeric.") and c in BUILTIN_TRANSCENDENTAL:
                g = np.asarray(got[c], np.float64)
                w64 = np.asarray(cpu64[key][c], np.float64)
                if not np.array_equal(np.isnan(g), np.isnan(w64)):
                    bad.append(f"{where} (NULLs)")
                    continue
                ok = ~np.isnan(w64)
                rel = np.abs(g[ok] - w64[ok]) / np.maximum(np.abs(w64[ok]),
                                                           1e-30)
                errs[where] = float(rel.max()) if rel.size else 0.0
                if errs[where] > BUILTIN_RTOL:
                    bad.append(f"{where} (relative error {errs[where]})")
            elif not same_column(got[c], w):
                if isinstance(w, list):
                    n = sum(a != b for a, b in zip(got[c], w))
                else:
                    n = int((np.asarray(got[c]) != w).sum()) \
                        if np.shape(got[c]) == w.shape else -1
                bad.append(f"{where} ({n} cells)")
    if bad:
        raise AssertionError("differ from the CPU run in the same policy: "
                             + ", ".join(bad))
    return errs


def builtin_hashes(res: dict) -> dict:
    """The hash step's numbers that BUILTIN_HASH_GOLDEN holds."""
    d = res["hashes"]["hashes"].to_pydict()
    h = [int(x) for x in d["h"]]
    return {"rows": len(h), "hash_sum": sum(h), "hash_head": h[:5],
            "xxhash64_sum_mod64": sum(int(x) for x in d["xh"]) % (1 << 64),
            "crc32_sum": sum(int(x) for x in d["cr"])}


def check_builtin_identities(res: dict, tables) -> dict:
    """What each step must give whatever the platform: the fluent and SQL
    numeric forms bit-identical; dates parsed back equal to themselves;
    the generators' row counts Σ(guest % 5 + 1) and three parts a row;
    the JSON fields equal to their sources; the draws of rand/randn equal
    to numpy's default_rng(seed) bit for bit and the ids to arange; the
    FROM-less row [2, 'A', 1]."""
    import torch

    from sparkdq4ml_tpu_torch.config import float_dtype, numpy_dtype

    num = summarize_builtins({"n": res["numeric"]})
    bad = differing(num["n.fluent"], num["n.sql"])
    if bad:
        raise AssertionError(f"fluent and selectExpr forms differ: {bad}")
    parsed = res["dates"]["parsed"].to_pydict()
    if not np.array_equal(parsed["d"], parsed["back"]):
        raise AssertionError("to_date(date_format(d)) differs from d")
    small = tables["small"].to_pydict()
    want_rows = int((np.fmod(small["guest"], 5) + 1).sum())
    counts = {k: res["arrays"][k].count()
              for k in ("posexploded", "exploded", "parts")}
    if counts["posexploded"] != want_rows or counts["exploded"] != want_rows:
        raise AssertionError(f"generator rows {counts}, expected "
                             f"{want_rows}")
    if counts["parts"] != 3 * len(small["guest"]):
        raise AssertionError(f"split parts {counts['parts']}")
    pos = res["arrays"]["posexploded"].to_pydict()
    seq = np.concatenate([np.arange(int(g) % 5 + 1) for g in small["guest"]])
    if not np.array_equal(pos["pos"], seq) or \
            not np.array_equal(pos["col"], seq + 1):
        raise AssertionError("posexplode positions or values differ")
    js = res["hashes"]["json"].to_pydict()
    tup = res["hashes"]["tuple"].to_pydict()
    if list(js["jb"]) != list(small["band"]) or \
            list(tup["c1"]) != list(small["band"]) or \
            list(tup["c0"]) != [str(g) for g in small["guest"]]:
        raise AssertionError("JSON fields differ from their sources")
    drawn = res["row_functions"]["drawn"]
    n = drawn.num_slots
    dt = numpy_dtype(float_dtype())
    r = drawn._column_values("r").cpu().numpy()
    z = drawn._column_values("n").cpu().numpy()
    if not (np.array_equal(r, np.random.default_rng(BUILTIN_SEED).uniform(
            size=n).astype(dt)) and np.array_equal(z, np.random.default_rng(
                BUILTIN_SEED).standard_normal(size=n).astype(dt))):
        raise AssertionError("rand/randn differ from numpy's draw")
    by_name = res["row_functions"]["by_name"]
    if not (torch.equal(by_name._column_values("r"),
                        drawn._column_values("r"))
            and torch.equal(by_name._column_values("n"),
                            drawn._column_values("n"))):
        raise AssertionError("rand/randn by name differ from the fluent "
                             "form")
    if not np.array_equal(drawn._column_values("id").cpu().numpy(),
                          np.arange(n)):
        raise AssertionError("monotonically_increasing_id is not arange")
    one = res["row_functions"]["one_row"].collect()
    if [tuple(r_) for r_ in one] != [(2, "A", 1)]:
        raise AssertionError(f"SELECT without FROM gave {one}")
    return {"generator_rows": want_rows, "split_rows": counts["parts"],
            "drawn_slots": n}


def timestamps(device: str, guest, price) -> dict:
    """The timestamp family on the first BUILTIN_HEAD clean rows under the
    float64 policy (summarized), with its identities: from_unixtime of
    unix_timestamp gives the text back, hour is pmod(guest, 24), minute
    30, second 15, to_timestamp equals unix_timestamp and date_trunc
    drops 30:15. Under float32 the same query raises ValueError."""
    spark = session(device)
    try:
        return _timestamps(spark, device, guest, price)
    finally:
        spark.stop()


def _timestamps(spark, device: str, guest, price) -> dict:
    import torch

    from sparkdq4ml_tpu_torch.config import float_policy
    from sparkdq4ml_tpu_torch.ops.rules import dq_rules_fused

    with float_policy(torch.float32):
        raw = spark.createDataFrame({"guest": guest, "price": price})
        keep = dq_rules_fused(raw.col("price").eval(raw),
                              raw.col("guest").eval(raw))[2]
        rows = np.flatnonzero(keep.cpu().numpy())[:BUILTIN_HEAD]
        spark.createDataFrame({"guest": guest[rows], "price": price[rows]}
                              ).create_or_replace_temp_view("stamped")
        try:
            spark.sql(TIMESTAMP_SQL).count()
        except ValueError:
            pass
        else:
            raise AssertionError("the timestamp family ran under float32")
    with float_policy(torch.float64):
        spark.createDataFrame({"guest": guest[rows], "price": price[rows]}
                              ).create_or_replace_temp_view("stamped")
        out = spark.sql(TIMESTAMP_SQL)
        d = out.to_pydict()
        for name in ("t1", "u1", "dt"):
            col = out._column_values(name)
            if col.dtype != torch.float64 or col.device.type != device:
                raise AssertionError(f"timestamp column {name}: {col.dtype} "
                                     f"on {col.device}")
        summary = summarize_builtins({"ts": {"stamps": out}})
    g = guest[rows].astype(np.int64)
    if not (list(d["f1"]) == list(d["ts"])
            and np.array_equal(d["hh"], g % 24)
            and (d["mi"] == 30).all() and (d["ss"] == 15).all()
            and np.array_equal(d["t1"], d["u1"])
            and np.array_equal(d["dt"], d["t1"] - 1815.0)):
        raise AssertionError("timestamp identities fail")
    return summary


def builtin_reference(guest, price) -> dict:
    """The CPU runs phase 12 is held to: every step in float32, the
    numeric step in float64 on the prices rounded to float32 (the inputs
    the card computes on, so that the transcendental columns differ from
    it by their own rounding only; the rules keep the same rows, as no
    two-decimal price lies within a float32 rounding of a rule's bound),
    each once, and the float64 timestamps."""
    import torch

    from sparkdq4ml_tpu_torch.config import float_policy

    out = {}
    price32 = price.astype(np.float32).astype(np.float64)
    for name, dtype, prices, names in (
            ("cpu32", torch.float32, price, None),
            ("cpu64", torch.float64, price32, ("numeric",))):
        with float_policy(dtype):
            spark, tables = builtin_tables("cpu", guest, prices)
            out[name] = summarize_builtins(first_runs(run_builtins(
                spark, tables, names=names)))
            spark.stop()
    out["timestamps"] = timestamps("cpu", guest, price)
    return out


def check_builtins_full(guest, price, reference=None) -> dict:
    """Phase 12 on the 10^7-row table: the CPU references (from
    ``reference``'s worker when given, else run here), then the card
    (float32) with the launch counts set to 0 just before the table
    is cleaned and read just after the steps (dq_rules once); every step's
    median of 3 host-clock times and one more run under torch.profiler;
    the numeric and date results on the card; every column against the
    CPU float32 run bit for bit (the transcendental ones within
    BUILTIN_RTOL of the CPU float64 run); the hashes against
    BUILTIN_HASH_GOLDEN; the identities; the timestamp family under the
    float64 policy against its CPU run. The string step runs on the first
    BUILTIN_HEAD clean rows only: on every clean row it takes 34.7 s on
    an H100 80GB HBM3 host (PERF.md §5), past the phase's 150 s with the
    rest."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    if reference is None:
        t0 = time.perf_counter()
        ref = builtin_reference(guest, price)
        cpu_s = time.perf_counter() - t0
    else:
        ref, timing = reference.result("builtins")
        cpu_s = timing["reference_s"]
        log(f"phase 12's cpu references: {timing}")
    spark, tables = builtin_tables("cuda", guest[:1000], price[:1000])
    run_builtins(spark, tables)                             # warm-up
    spark.stop()
    times: dict = {}
    torch.cuda.synchronize()
    kernels.launches.reset()
    t0 = time.perf_counter()
    spark, tables = builtin_tables("cuda", guest, price)
    outs = run_builtins(spark, tables, times, runs=3)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = kernels.launches.snapshot()
    if counts["dq_rules"] != 1:
        raise AssertionError(f"the builtin phase launched dq_rules "
                             f"{counts['dq_rules']} times, expected 1")
    first = first_runs(outs)
    for step in ("numeric", "dates"):
        for name, frame in first[step].items():
            for c in frame.columns:
                col = frame._column_values(c)
                if isinstance(col, torch.Tensor) and \
                        col.device.type != "cuda":
                    raise AssertionError(f"{step}.{name}.{c} is not on the "
                                         "card")
    prof = profile_run("builtins", lambda: run_builtins(spark, tables))
    steps_ms = {k: 1e3 * float(np.median(v)) for k, v in times.items()}
    log(f"builtins on the card: step ms (median) {steps_ms}; runs s "
        f"{times}; cpu references {cpu_s:.1f} s; profile {prof}")
    card = summarize_builtins(first)
    errs = check_builtins(card, ref["cpu32"], ref["cpu64"])
    hashes = builtin_hashes(first)
    if hashes != BUILTIN_HASH_GOLDEN:
        raise AssertionError(f"hashes {hashes} differ from the JAX "
                             f"package's {BUILTIN_HASH_GOLDEN}")
    identities = check_builtin_identities(first, tables)
    spark.stop()
    t0 = time.perf_counter()
    stamps = timestamps("cuda", guest, price)
    stamps_s = time.perf_counter() - t0
    bad = differing(stamps["ts.stamps"], ref["timestamps"]["ts.stamps"])
    if bad:
        raise AssertionError(f"timestamps differ from the CPU run: {bad}")
    log(f"builtins at {len(guest)} rows, card float32: step ms (median) "
        f"{steps_ms}; runs s {times}; launches {counts}; identities "
        f"{identities}; hashes {hashes}; profile {prof}; cpu reference "
        f"{cpu_s:.1f} s; timestamps {stamps_s:.1f} s; errors against cpu "
        f"float64 {errs}")
    return {"rows": len(guest), "steps_ms": steps_ms, "runs_s": times,
            "path_s": path_s, "launches": counts, "identities": identities,
            "hashes": hashes, "profile": prof, "cpu_reference_s": cpu_s,
            "timestamps_s": stamps_s, "max_rel_err": errs}


# ---------------------------------------------------------------------------
# Phase 13: the model zoo
# ---------------------------------------------------------------------------

# The tour's model zoo (examples/ml_pipeline_tour.py:95-124) on
# dataset-full: the JAX package's output on the CPU under its default
# float32 policy (tests/test_torch_ml_tour_zoo.py holds these constants to
# it). The card's float32 run is held within ZOO_RTOL of the floats, the
# GLM's iterations within ZOO_ITERATION_SLACK, the accuracy and the sizes
# exactly.
ZOO_TOUR_GOLDEN = {
    "glm": {"deviance": 19.532018661499023, "aic": 8231.742370546057,
            "coef": 0.05274194851517677, "intercept": 3.6421897411346436,
            "iterations": 8},
    "gbt_rmse": 1.912324170249196, "rf_accuracy": 1.0,
    "silhouette": 0.7620003623580078, "kmeans_sizes": [298, 349, 377],
}
ZOO_RTOL = 1e-4
ZOO_ITERATION_SLACK = 1
# Phase 13(c)'s bounds against the CPU float64 run of the same steps.
ZOO_COEF_RTOL = 1e-4          # GLM coefficients and intercept
ZOO_DEVIANCE_RTOL = 1e-5      # GLM deviance
ZOO_METRIC_TOL = 1e-4         # GBT and tree RMSE (relative), RF accuracy
ZOO_CENTER_RTOL = 1e-5        # KMeans centers and silhouette
ZOO_LL_RTOL = 1e-4            # GMM log-likelihood
# A tree's split is held where the float64 run's best gain leads its
# runner-up by more than this, relative: a nearer tie may flip when the
# card's float32 histograms add in another order (printed, not held).
ZOO_SPLIT_MARGIN = 1e-4
# The float64 reference of these four fits runs on the card under the
# float64 policy: the same port code as the CPU run, its sums through the
# float64 segment-sum kernels, which check_segment_sum holds within 1e-12
# Σ|x| of their plain version at these fits' shapes. Their CPU float64 run
# at full size took 188 s on the card machine's host (PERF.md §6), past
# the phase's budget; the others' reference stays on the CPU.
ZOO_CARD_REFERENCE = ("gbt", "rf", "dt", "gmm")
PIC_NODES = 4096
PIC_COMMUNITIES = 3
PIC_DEGREE = 16


def zoo_tour(device: str) -> dict:
    """The tour's model zoo section through TorchSession on dataset-full:
    a gamma/log GLM, GBTRegressor(20, depth 3, step 0.2), RMSE;
    RandomForestClassifier(10 trees, depth 4) on guest > 25, accuracy;
    KMeans(k=3, seed=7) and its silhouette; the tour's own asserts."""
    from sparkdq4ml_tpu_torch.models import (ClusteringEvaluator,
                                             GBTRegressor,
                                             GeneralizedLinearRegression,
                                             KMeans, RandomForestClassifier,
                                             RegressionEvaluator)

    spark = session(device)
    fdf = dq_clean(spark, read_dataset(spark, "full"))
    ldf = fdf.with_column("label", (fdf.col("guest") > 25).cast("double"))
    glm = GeneralizedLinearRegression(family="gamma", link="log").fit(fdf)
    gbt = GBTRegressor(max_iter=20, max_depth=3, step_size=0.2).fit(fdf)
    gbt_rmse = RegressionEvaluator(metric_name="rmse").evaluate(
        gbt.transform(fdf))
    rf = RandomForestClassifier(num_trees=10, max_depth=4).fit(ldf)
    out = rf.transform(ldf).to_pydict()
    rf_acc = float(np.mean(out["prediction"] == out["label"]))
    km = KMeans(k=3, seed=7, features_col="features").fit(fdf)
    sil = ClusteringEvaluator(features_col="features").evaluate(
        km.transform(fdf))
    spark.stop()
    if not (gbt_rmse < 4.0 and rf_acc > 0.95 and sil > 0.5):
        raise AssertionError(f"the tour's asserts: GBT RMSE {gbt_rmse}, RF "
                             f"accuracy {rf_acc}, silhouette {sil}")
    return {"glm": {"deviance": glm.summary.deviance,
                    "aic": glm.summary.aic,
                    "coef": float(glm.coefficients[0]),
                    "intercept": glm.intercept,
                    "iterations": glm.summary.num_iterations},
            "gbt_rmse": gbt_rmse, "rf_accuracy": rf_acc,
            "silhouette": sil,
            "kmeans_sizes": sorted(km.summary.cluster_sizes)}


def check_zoo_tour_golden(device: str) -> dict:
    """Phase 13(a): ``zoo_tour`` against ZOO_TOUR_GOLDEN."""
    got = zoo_tour(device)
    want = ZOO_TOUR_GOLDEN
    bad = [f"glm {k} {got['glm'][k]} vs {v}"
           for k, v in want["glm"].items() if k != "iterations"
           and abs(got["glm"][k] - v) > ZOO_RTOL * abs(v)]
    if abs(got["glm"]["iterations"] - want["glm"]["iterations"]) > \
            ZOO_ITERATION_SLACK:
        bad.append(f"glm iterations {got['glm']['iterations']}")
    for k in ("gbt_rmse", "silhouette"):
        if abs(got[k] - want[k]) > ZOO_RTOL * abs(want[k]):
            bad.append(f"{k} {got[k]} vs {want[k]}")
    for k in ("rf_accuracy", "kmeans_sizes"):
        if got[k] != want[k]:
            bad.append(f"{k} {got[k]} vs {want[k]}")
    if bad:
        raise AssertionError(f"the tour's model zoo on dataset-full: {bad}")
    log(f"tour model zoo on dataset-full, {device} float32: {got}")
    return got


def zoo_frames(clean):
    """The clean table assembled ([guest]) with the tour's two labels:
    ``fdf`` (label = price) and ``ldf`` (label = guest > 25)."""
    from sparkdq4ml_tpu_torch.models import VectorAssembler

    fdf = VectorAssembler(["guest"], "features").transform(
        clean.with_column("label", clean.col("price")))
    return fdf, fdf.with_column("label",
                                (fdf.col("guest") > 25).cast("double"))


def _valid_share(frame, pred: str, label: str) -> float:
    """The share of valid rows whose ``pred`` equals ``label``, on the
    frame's device."""
    hit = frame._column_values(pred) == frame._column_values(label)
    return float((hit & frame.mask).sum()) / float(frame.mask.sum())


def zoo_fits():
    """(name, fn(fdf, ldf) -> host results) of phase 13(b), in order."""
    from sparkdq4ml_tpu_torch.models import (BisectingKMeans,
                                             ClusteringEvaluator,
                                             DecisionTreeRegressor,
                                             GaussianMixture, GBTRegressor,
                                             GeneralizedLinearRegression,
                                             KMeans, RandomForestClassifier,
                                             RegressionEvaluator)

    def trees(m):
        return {f: np.array(getattr(m, f))
                for f in ("feature", "threshold", "is_leaf", "value",
                          "gain")}

    def rmse(m, fdf):
        return RegressionEvaluator(metric_name="rmse").evaluate(
            m.transform(fdf))

    def glm(fdf, ldf):
        m = GeneralizedLinearRegression(family="gamma", link="log").fit(fdf)
        return {"coef": [float(c) for c in m.coefficients],
                "intercept": m.intercept, "deviance": m.summary.deviance,
                "iterations": m.summary.num_iterations}

    def gbt(fdf, ldf):
        m = GBTRegressor(max_iter=20, max_depth=3, step_size=0.2).fit(fdf)
        return {"rmse": rmse(m, fdf), **trees(m)}

    def rf(fdf, ldf):
        m = RandomForestClassifier(num_trees=10, max_depth=4).fit(ldf)
        return {"accuracy": _valid_share(m.transform(ldf), "prediction",
                                         "label"), **trees(m)}

    def dt(fdf, ldf):
        m = DecisionTreeRegressor().fit(fdf)
        return {"rmse": rmse(m, fdf), **trees(m)}

    def kmeans(fdf, ldf):
        m = KMeans(k=3, seed=7).fit(fdf)
        return {"sizes": list(m.cluster_sizes),
                "centers": [float(c) for c in np.ravel(m.centers)],
                "cost": m.training_cost, "iterations": m.num_iters,
                "silhouette": ClusteringEvaluator().evaluate(
                    m.transform(fdf))}

    def gmm(fdf, ldf):
        m = GaussianMixture(k=3).fit(fdf)
        return {"log_likelihood": m.log_likelihood,
                "iterations": m.num_iters,
                "weights": [float(w) for w in m.weights],
                "means": [float(v) for v in np.ravel(m.means)]}

    def bisecting(fdf, ldf):
        m = BisectingKMeans(k=4).fit(fdf)
        return {"sizes": list(m.cluster_sizes), "cost": m.training_cost}

    return [("glm", glm), ("gbt", gbt), ("rf", rf), ("dt", dt),
            ("kmeans", kmeans), ("gmm", gmm), ("bisecting", bisecting)]


def pic_graph(nodes: int = PIC_NODES, seed: int = 0) -> dict:
    """A similarity graph of ``PIC_COMMUNITIES`` planted communities:
    ``PIC_DEGREE`` edges a node to random members of its own community
    (weights in [0.5, 1), duplicates and self-loops included) and one weak
    edge in 16 across communities (weights below 0.01). Returns the graph
    and each node's community."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, PIC_COMMUNITIES, nodes)
    members = np.argsort(comm, kind="stable")
    size = np.bincount(comm, minlength=PIC_COMMUNITIES)
    start = np.concatenate([[0], np.cumsum(size)[:-1]])
    src = np.repeat(np.arange(nodes), PIC_DEGREE)
    pick = (rng.random(src.size) * size[comm[src]]).astype(np.int64)
    dst = members[start[comm[src]] + pick]
    weak = nodes // 16
    src = np.concatenate([src, rng.integers(0, nodes, weak)])
    dst = np.concatenate([dst, rng.integers(0, nodes, weak)])
    w = np.concatenate([rng.uniform(0.5, 1.0, nodes * PIC_DEGREE),
                        rng.uniform(0.0, 0.01, weak)])
    return {"src": src, "dst": dst, "weight": w}, comm


def partition(labels) -> np.ndarray:
    """Cluster labels renamed in order of first appearance: two
    clusterings are the same partition when these are equal."""
    labels = np.asarray(labels)
    _, first = np.unique(labels, return_index=True)
    rename = np.empty(len(first), np.int64)
    rename[np.argsort(first)] = np.arange(len(first))
    return rename[np.searchsorted(np.unique(labels), labels)]


def pic_run(device: str, graph: dict) -> np.ndarray:
    """PowerIterationClustering(k=PIC_COMMUNITIES) on ``graph``; the
    assignments in the order of the ids."""
    from sparkdq4ml_tpu_torch.frame.frame import Frame
    from sparkdq4ml_tpu_torch.models import PowerIterationClustering

    out = PowerIterationClustering(k=PIC_COMMUNITIES, seed=0).assign_clusters(
        Frame(dict(graph), device=device)).to_pydict()
    return np.asarray(out["cluster"])


def same_results(a, b) -> list:
    """The keys where two results of one fit differ in any bit."""
    bad = []
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape or x.tobytes() != y.tobytes():
            bad.append(k)
    return bad


def split_gate(card: dict, cpu: dict, margins: list, sequential: bool):
    """Each tree's splits against the float64 run: at every node whose
    ancestors split alike and whose float64 best gain leads the runner-up
    by more than ZOO_SPLIT_MARGIN relative (or that float64 did not
    split), the card's leaf flag, split feature and threshold must equal
    the float64 run's; where float64 did not split but the card did, with
    a gain under ZOO_SPLIT_MARGIN of its root's (float32 rounding over a
    pure node), the node is printed, not held. ``margins`` holds the
    float64 run's two best gains a node, one (m, 2) array a tree and level
    in fit order. In a GBT
    (``sequential``) every tree after one with a near tie is left out: its
    gradients follow the tie. Returns (nodes held, near ties printed)."""
    feat_f, thr_f, leaf_f = cpu["feature"], cpu["threshold"], cpu["is_leaf"]
    T, N = feat_f.shape
    levels = int(np.log2(N + 1)) - 1
    held, ties = 0, []
    for t in range(T):
        ok = {0}
        for level in range(levels):
            top = margins[t * levels + level]
            base = 2 ** level - 1
            for j in range(2 ** level):
                node = base + j
                if node not in ok:
                    continue
                best, second = (float(top[j, 0]),
                                float(top[j, 1]) if top.shape[1] > 1
                                else -1e30)
                lead = (best - second) / max(abs(best), 1e-300)
                if not leaf_f[t, node] and lead <= ZOO_SPLIT_MARGIN:
                    ties.append({"tree": t, "node": node, "lead": lead})
                    continue
                if leaf_f[t, node] and not card["is_leaf"][t, node] and \
                        card["gain"][t, node] <= ZOO_SPLIT_MARGIN * abs(
                            card["gain"][t, 0]):
                    # float64 found no gain (a pure node); the card's
                    # float32 impurities round to a gain of nothing
                    ties.append({"tree": t, "node": node, "lead": lead,
                                 "card_gain": float(card["gain"][t, node])})
                    continue
                same = (card["is_leaf"][t, node] == leaf_f[t, node]) and (
                    leaf_f[t, node] or (
                        card["feature"][t, node] == feat_f[t, node]
                        and card["threshold"][t, node]
                        == np.float32(thr_f[t, node])))
                if not same:
                    raise AssertionError(
                        f"tree {t} node {node}: the card's split (leaf "
                        f"{card['is_leaf'][t, node]}, feature "
                        f"{card['feature'][t, node]}, threshold "
                        f"{card['threshold'][t, node]}) is not float64's "
                        f"({leaf_f[t, node]}, {feat_f[t, node]}, "
                        f"{thr_f[t, node]}), whose gain leads by {lead}")
                held += 1
                if not leaf_f[t, node]:
                    ok.update((2 * node + 1, 2 * node + 2))
        if sequential and any(tie["tree"] == t for tie in ties):
            break
    return held, ties


def check_zoo(card: dict, ref: dict, launches: dict) -> dict:
    """Phase 13(c)'s gates against the float64 reference ``ref``; returns
    the trees' held nodes and near ties."""
    bad = []

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-300)

    g, w = card["glm"], ref["glm"]
    for a, b in zip(g["coef"] + [g["intercept"]],
                    w["coef"] + [w["intercept"]]):
        if rel(a, b) > ZOO_COEF_RTOL:
            bad.append(f"glm coefficients {g} vs {w}")
    if rel(g["deviance"], w["deviance"]) > ZOO_DEVIANCE_RTOL:
        bad.append(f"glm deviance {g['deviance']} vs {w['deviance']}")
    if launches["glm"]["masked_gram"] != g["iterations"] + 1:
        bad.append(f"glm masked_gram launches {launches['glm']}, "
                   f"{g['iterations']} iterations")
    for name in ("gbt", "dt"):
        if rel(card[name]["rmse"], ref[name]["rmse"]) > ZOO_METRIC_TOL:
            bad.append(f"{name} RMSE {card[name]['rmse']} vs "
                       f"{ref[name]['rmse']}")
    if abs(card["rf"]["accuracy"] - ref["rf"]["accuracy"]) > ZOO_METRIC_TOL:
        bad.append(f"rf accuracy {card['rf']['accuracy']} vs "
                   f"{ref['rf']['accuracy']}")
    k, kw = card["kmeans"], ref["kmeans"]
    if k["sizes"] != kw["sizes"]:
        bad.append(f"kmeans sizes {k['sizes']} vs {kw['sizes']}")
    if any(rel(a, b) > ZOO_CENTER_RTOL
           for a, b in zip(k["centers"], kw["centers"])) or \
            rel(k["silhouette"], kw["silhouette"]) > ZOO_CENTER_RTOL:
        bad.append(f"kmeans {k} vs {kw}")
    if rel(card["gmm"]["log_likelihood"],
           ref["gmm"]["log_likelihood"]) > ZOO_LL_RTOL:
        bad.append(f"gmm log-likelihood {card['gmm']} vs {ref['gmm']}")
    if card["bisecting"]["sizes"] != ref["bisecting"]["sizes"]:
        bad.append(f"bisecting sizes {card['bisecting']} vs "
                   f"{ref['bisecting']}")
    # the k-means seeding of PIC's embedding draws by float32 or float64
    # distances, which may name the clusters differently: the assignments
    # are held as partitions, to the CPU run's and to the planted one
    if not (np.array_equal(partition(card["pic"]["assignments"]),
                           partition(ref["pic"]["assignments"]))
            and np.array_equal(partition(ref["pic"]["assignments"]),
                               partition(ref["pic"]["planted"]))):
        bad.append("pic assignments differ from the CPU float64 run's or "
                   "the planted communities")
    for name in ("gbt", "rf", "dt", "kmeans", "bisecting"):
        segs = launches[name]["dense_segment_sum"] + \
            launches[name]["sorted_segment_sum"]
        if segs == 0:
            bad.append(f"{name} launched no segment sum: {launches[name]}")
    if launches["dt"]["sorted_segment_sum"] == 0:
        bad.append(f"dt never took the sorted route: {launches['dt']}")
    if bad:
        raise AssertionError(f"phase 13 gates: {bad}")
    splits = {}
    for name in ("gbt", "rf", "dt"):
        held, ties = split_gate(card[name], ref[name],
                                ref[name]["margins"], name == "gbt")
        splits[name] = {"nodes_held": held, "near_ties": ties}
    return splits


def check_zoo_full(rows: int = FULL_ROWS) -> dict:
    """Phase 13(b)-(c): the seven fits on the DQ-clean 10^7-row table
    (cleaned by one dq_rules launch) and PIC on a PIC_NODES-node graph, on
    the card in float32 twice each (bit-identical), each with the launch
    counts set to 0 just before it and read just after, and one GBT fit
    under torch.profiler; then the float64 run of the same steps on the
    same rows (ZOO_CARD_REFERENCE on the card, the others and PIC on the
    CPU), recording the two best split gains of every node, and the
    gates."""
    import torch

    from sparkdq4ml_tpu_torch.config import float_policy
    from sparkdq4ml_tpu_torch.models import tree as port_tree
    from sparkdq4ml_tpu_torch.ops import kernels

    fits = zoo_fits()
    guest, price = full_table(rows)
    graph, planted = pic_graph()
    t_card = time.perf_counter()
    spark, clean = clean_table("cuda", guest[:20_000], price[:20_000])
    fdf, ldf = zoo_frames(clean)
    for _, fn in fits:                                      # warm-up
        fn(fdf, ldf)
    spark.stop()
    torch.cuda.synchronize()
    kernels.launches.reset()
    spark, clean = clean_table("cuda", guest, price)
    torch.cuda.synchronize()
    clean_counts = kernels.launches.snapshot()
    kept = clean.count()
    fdf, ldf = zoo_frames(clean)
    card, launches, fit_ms, differ = {}, {}, {}, {}
    for name, fn in fits:
        card[name], launches[name], s1 = driven(fn, fdf, ldf)
        again, _, s2 = driven(fn, fdf, ldf)
        differ[name] = same_results(card[name], again)
        fit_ms[name] = [1e3 * s1, 1e3 * s2]
    profiles = {"gbt": profile_run("zoo_gbt",
                                   lambda: dict(fits)["gbt"](fdf, ldf))}
    pic, launches["pic"], s1 = driven(pic_run, "cuda", graph)
    again, _, s2 = driven(pic_run, "cuda", graph)
    card["pic"] = {"assignments": pic}
    differ["pic"] = [] if np.array_equal(pic, again) else ["assignments"]
    fit_ms["pic"] = [1e3 * s1, 1e3 * s2]
    spark.stop()
    card_s = time.perf_counter() - t_card
    bad = {k: v for k, v in differ.items() if v}
    if bad:
        raise AssertionError(f"phase 13 fits differ between two card runs: "
                             f"{bad}")
    if clean_counts["dq_rules"] != 1:
        raise AssertionError(f"the zoo table: {clean_counts}")

    margins = []
    real = port_tree._split_gains

    def recording(*args, **kwargs):
        flat = real(*args, **kwargs)
        margins.append(torch.topk(flat, min(2, flat.shape[1]),
                                  dim=1).values.cpu().numpy())
        return flat

    ref, ref_kept, ref_s = {}, {}, {}
    port_tree._split_gains = recording
    try:
        with float_policy(torch.float64):
            for dev in ("cuda", "cpu"):
                t0 = time.perf_counter()
                spark, ref_clean = clean_table(dev, guest, price)
                rfdf, rldf = zoo_frames(ref_clean)
                for name, fn in fits:
                    if (name in ZOO_CARD_REFERENCE) != (dev == "cuda"):
                        continue
                    first = len(margins)
                    ref[name] = fn(rfdf, rldf)
                    ref[name]["margins"] = margins[first:]
                ref_kept[dev] = ref_clean.count()
                spark.stop()
                if dev == "cpu":
                    ref["pic"] = {"assignments": pic_run("cpu", graph),
                                  "planted": planted}
                ref_s[dev] = time.perf_counter() - t0
    finally:
        port_tree._split_gains = real
    if set(ref_kept.values()) != {kept}:
        raise AssertionError(f"clean rows card {kept}, float64 {ref_kept}")
    splits = check_zoo(card, ref, launches)
    summary = {name: {k: v for k, v in res.items()
                      if not isinstance(v, np.ndarray)}
               for name, res in card.items() if name != "pic"}
    summary["pic"] = {"sizes": np.bincount(pic).tolist()}
    reference = {name: {k: v for k, v in res.items()
                        if not isinstance(v, np.ndarray) and k != "margins"}
                 for name, res in ref.items()}
    segment_launches = {name: {k: c[k] for k in ("dense_segment_sum",
                                                 "sorted_segment_sum")}
                        for name, c in launches.items()}
    log(f"model zoo at {rows} rows ({kept} clean), card float32: "
        f"{json.dumps(summary, default=str)}; fit ms {fit_ms}; segment-sum "
        f"launches {segment_launches}; masked_gram launches "
        f"{launches['glm']['masked_gram']} for "
        f"{card['glm']['iterations']} IRLS iterations; splits held and "
        f"near ties {json.dumps(splits)}; profiles {profiles}; float64 "
        f"reference s {ref_s} (card: {list(ZOO_CARD_REFERENCE)})")
    return {"rows": rows, "clean_rows": kept, "fits": summary,
            "float64_reference": reference, "fit_ms": fit_ms,
            "launches": launches, "splits": splits, "profiles": profiles,
            "float64_on_card": ZOO_CARD_REFERENCE,
            "pic_nodes": PIC_NODES, "card_s": card_s,
            "card_float64_reference_s": ref_s["cuda"],
            "cpu_float64_reference_s": ref_s["cpu"]}


def argmax_first_on_card() -> None:
    """torch.argmax takes the first of tied maxima on the card, as
    jnp.argmax does (the tree splits rely on it): along rows of a split
    table and over a long vector."""
    import torch

    gains = torch.zeros((64, 31 * 3), device="cuda")
    gains[:, 5] = gains[:, 40] = gains[:, 92] = 1.0
    long = torch.zeros(10_000_000, device="cuda")
    long[[123, 4_567_890, 9_999_999]] = 2.0
    if not (bool((torch.argmax(gains, dim=1) == 5).all())
            and int(torch.argmax(long)) == 123
            and int(torch.argmin(-long)) == 123):
        raise AssertionError("torch.argmax/argmin on the card does not take "
                             "the first of tied extremes")


def zoo_segment_cases():
    """(name, kernel, x, seg, size) at the model zoo's segment-sum shapes
    on the DQ-clean full table: GBT's histograms at depth 2 and at its last
    level, depth 3 (8 nodes x 32 bins, [w, wg, wg², wh]), the forest's at
    depth 3 and at its last level, depth 4 (16 nodes, two class counts
    under Poisson bootstrap weights), the tree's depth-5 level past shared
    memory (1,024 slots, sorted route: the ids sorted first, as
    ops/segments.py does), KMeans' k = 3 slots ([x·w, w, cost]), and PIC's
    affinity: the values and slots of ``pic_graph``'s 2·65,792 entries
    onto PIC_NODES² slots, as PowerIterationClustering.affinity_entries
    makes them, sorted as ops/segments.py sorts them."""
    import torch

    from sparkdq4ml_tpu_torch.frame.frame import Frame
    from sparkdq4ml_tpu_torch.models import PowerIterationClustering

    guest, price = clean_columns()
    n = guest.shape[0]
    g = torch.clamp(guest - 1, 0, 31)
    rng = np.random.default_rng(0)
    node = torch.as_tensor(rng.integers(0, 16, n), device=guest.device)
    p = price
    one = torch.ones_like(p)
    grad = p - p.mean()
    label = (guest > 25).to(p.dtype)
    boot = torch.as_tensor(rng.poisson(1.0, n), device=guest.device).to(
        p.dtype)
    deep = torch.as_tensor(rng.integers(0, 32, n), device=guest.device)
    order = torch.sort(deep * 32 + g, stable=True)
    graph, _ = pic_graph()
    ids, vals, slots = PowerIterationClustering(
        k=PIC_COMMUNITIES).affinity_entries(Frame(dict(graph),
                                                  device="cuda"))
    by_slot = torch.sort(slots, stable=True)
    return [("gbt level 2", "dense_segment_sum",
             torch.stack([one, p, p * p, one], dim=1), (node % 4) * 32 + g,
             128),
            ("gbt level 3", "dense_segment_sum",
             torch.stack([one, grad, grad * grad, one], dim=1),
             (node % 8) * 32 + g, 256),
            ("forest level 3", "dense_segment_sum",
             torch.stack([one, label], dim=1), (node % 8) * 32 + g, 256),
            ("forest level 4", "dense_segment_sum",
             torch.stack([boot * (1 - label), boot * label], dim=1),
             node * 32 + g, 512),
            ("tree level 5 (sorted)", "sorted_segment_sum",
             torch.stack([one, p, p * p], dim=1).index_select(
                 0, order.indices), order.values, 1024),
            ("kmeans k=3", "dense_segment_sum",
             torch.stack([guest.to(p.dtype), one, p], dim=1),
             (guest % 3).to(torch.int64), 3),
            ("pic affinity (sorted)", "sorted_segment_sum",
             vals.index_select(0, by_slot.indices), by_slot.values,
             len(ids) ** 2)]


# ---------------------------------------------------------------------------
# Phase 14: the ML tour's second half
# ---------------------------------------------------------------------------

# The tour's second half (examples/ml_pipeline_tour.py:125-224) on
# dataset-full: the JAX package's output under its default float32 policy
# (x64 off); tests/test_torch_ml_tour_rest.py holds these constants to it.
TOUR_REST_GOLDEN = {
    "svc_accuracy": 1.0, "fm_accuracy": 0.995,
    "fm_intercept": -0.7972393035888672,
    "iso_predict_30": 171.61420962685034, "iso_boundaries": 35,
    "aft": {"coef": 0.2750423848628998, "intercept": 1.095998764038086,
            "scale": 0.4076243042945862},
    "fpgrowth": {"itemsets": [[["beer"], 2], [["cheese"], 3], [["chips"], 2],
                              [["wine"], 3], [["beer", "chips"], 2],
                              [["cheese", "wine"], 3]],
                 "antecedent": [["chips"], ["beer"], ["wine"], ["cheese"]],
                 "consequent": [["beer"], ["chips"], ["cheese"], ["wine"]],
                 "confidence": [1.0, 1.0, 1.0, 1.0]},
    "synonyms": {"words": ["grapes", "cheese"],
                 "similarity": [0.9999932646751404, 0.9978628754615784]},
    "lsh_distances": [0.0, 0.12042682617902756, 0.1338137984275818],
    "lda_top_terms": [[0, 3, 2], [8, 6, 10]],
    "lda_log_perplexity": 1.8785404459635417,
    "pic_clusters": [1, 1, 1, 0, 0, 0],
    "prefixspan": {"sequences": [[["cart"]], [["home"]], [["home"], ["cart"]],
                                 [["home"], ["search"]],
                                 [["home"], ["search"], ["cart"]],
                                 [["search"]], [["search"], ["cart"]]],
                   "freq": [4, 3, 3, 2, 2, 3, 3]},
}
# Held exactly; isotonic's predict(30) within REST_PREDICT_ATOL (float64 on
# both sides); the rest within REST_ATOL of the JAX package's float32 output.
REST_EXACT = ("svc_accuracy", "fm_accuracy", "iso_boundaries", "fpgrowth",
              "lda_top_terms", "pic_clusters", "prefixspan")
REST_PREDICT_ATOL = 1e-9
REST_ATOL = 1e-4
# Phase 14(b)'s sizes.
W2V_DOCS, W2V_WORDS, W2V_TOPICS = 100_000, 2000, 20
FP_BASKETS, FP_ITEMS = 100_000, 50
PS_SESSIONS, PS_PAGES = 10_000, 20
LSH_JOIN_ROWS, LSH_HASH_ROWS, ANN_QUERIES = 10_000, 1_000_000, 10
MINHASH_ROWS, MINHASH_COLS = 10_000, 256
LDA_DOCS, LDA_TERMS, LDA_TOPICS, LDA_TOKENS = 100_000, 1024, 10, 100
W2V_NEGATIVE_STEPS = 8          # steps whose negatives numpy redraws
# The profiled Word2Vec fit runs on the first this many documents (about
# 170 steps of the same shapes): a trace of every step of the whole fit
# takes over a minute to gather.
W2V_PROFILED_DOCS = 10_000
# Phase 14(c)'s gates against the float64 run of the same steps.
FM_LOSS_RTOL, FM_ACCURACY_TOL = 1e-4, 1e-3
AFT_TOL = 1e-3
ISO_PREDICT_TOL = 1e-9
W2V_LOSS_RTOL, W2V_MARGIN = 1e-3, 1e-3
LSH_EDGE, LSH_DIST_TOL = 1e-5, 1e-5
LDA_RTOL, LDA_MARGIN = 1e-4, 1e-4    # λ relative to its topic's largest


def rest_tour(device: str) -> dict:
    """The tour's second half through TorchSession on dataset-full, in
    the tour's order and with its one numpy generator: LinearSVC's
    accuracy, FMClassifier on the XOR quadrants, IsotonicRegression guest →
    price, AFTSurvivalRegression, FPGrowth, Word2Vec's synonyms of "wine",
    BucketedRandomProjectionLSH's 3-NN, LDA (em), PIC over two triangles
    and PrefixSpan."""
    import sparkdq4ml_tpu_torch as dq
    from sparkdq4ml_tpu_torch import Frame
    from sparkdq4ml_tpu_torch.models import (AFTSurvivalRegression,
                                             BucketedRandomProjectionLSH,
                                             FMClassifier, FPGrowth,
                                             IsotonicRegression, LDA,
                                             LinearSVC,
                                             PowerIterationClustering,
                                             PrefixSpan, VectorAssembler,
                                             Word2Vec)

    spark = session(device)
    fdf = dq_clean(spark, read_dataset(spark, "full"))
    ldf = fdf.with_column("label", (fdf.col("guest") > 25).cast("double"))
    out = {}
    so = LinearSVC(max_iter=100, reg_param=0.01).fit(ldf).transform(
        ldf).to_pydict()
    out["svc_accuracy"] = float(np.mean(so["prediction"] == so["label"]))
    rng = np.random.default_rng(0)
    Xf = rng.normal(size=(400, 2))
    yf = (Xf[:, 0] * Xf[:, 1] > 0).astype(np.float64)
    fm_df = VectorAssembler(["a", "b"], "features").transform(
        Frame({"a": Xf[:, 0], "b": Xf[:, 1], "label": yf}))
    fm = FMClassifier(factor_size=4, max_iter=400, step_size=0.05,
                      seed=1).fit(fm_df)
    out["fm_accuracy"] = float(np.mean(np.asarray(
        fm.transform(fm_df).to_pydict()["prediction"]) == yf))
    out["fm_intercept"] = fm.intercept
    d = fdf.to_pydict()
    iso = IsotonicRegression().fit(Frame({
        "features": np.asarray(d["guest"], np.float64),
        "label": np.asarray(d["price"], np.float64)}))
    out["iso_predict_30"] = iso.predict(30.0)
    out["iso_boundaries"] = len(iso.boundaries)
    t = np.exp(1.0 + 0.3 * Xf[:, 0]
               + 0.4 * np.log(rng.exponential(size=400)))
    aft = AFTSurvivalRegression(max_iter=300).fit(
        VectorAssembler(["a"], "features").transform(Frame({
            "a": Xf[:, 0], "label": t,
            "censor": (rng.random(400) > 0.2).astype(np.float64)})))
    out["aft"] = {"coef": float(aft.coefficients[0]),
                  "intercept": aft.intercept, "scale": aft.scale}
    fp = FPGrowth(min_support=0.4, min_confidence=0.7).fit(Frame({
        "items": dq.list_column([["wine", "cheese"],
                                 ["wine", "cheese", "bread"],
                                 ["beer", "chips"],
                                 ["wine", "cheese", "grapes"],
                                 ["beer", "chips", "salsa"]])}))
    rules = fp.association_rules.to_pydict()
    out["fpgrowth"] = {
        "itemsets": [[list(s), int(c)] for s, c in fp.itemsets],
        "antecedent": [list(a) for a in rules["antecedent"]],
        "consequent": [list(c) for c in rules["consequent"]],
        "confidence": [float(c) for c in rules["confidence"]]}
    docs = Frame({"toks": dq.list_column(
        [list(rng.choice(["wine", "cheese", "grapes"], 6))
         if rng.random() < 0.5 else
         list(rng.choice(["beer", "chips", "salsa"], 6))
         for _ in range(200)])})
    w2v = Word2Vec(vector_size=8, min_count=1, max_iter=8, window_size=3,
                   batch_size=256, seed=1, input_col="toks",
                   output_col="vec").fit(docs)
    syn = w2v.find_synonyms("wine", 2).to_pydict()
    out["synonyms"] = {"words": [str(w) for w in syn["word"]],
                       "similarity": [float(s) for s in syn["similarity"]]}
    lsh = BucketedRandomProjectionLSH(bucket_length=2.0, num_hash_tables=4,
                                      seed=3).fit(fm_df)
    nn = lsh.approx_nearest_neighbors(fm_df, Xf[0], 3)
    out["lsh_distances"] = [float(v) for v in np.sort(np.asarray(
        nn.to_pydict()["distCol"]))]
    topics = Frame({"features": np.stack(
        [np.bincount(rng.integers(0, 6, 40), minlength=12).astype(np.float64)
         if rng.random() < 0.5 else
         np.bincount(rng.integers(6, 12, 40), minlength=12).astype(
             np.float64) for _ in range(60)])})
    lda = LDA(k=2, max_iter=25, optimizer="em", seed=1).fit(topics)
    out["lda_top_terms"] = [list(map(int, t)) for t in
                            lda.describe_topics(3).to_pydict()["termIndices"]]
    out["lda_log_perplexity"] = lda.log_perplexity(topics)
    ring = Frame({
        "src": np.asarray([0, 1, 2, 3, 4, 5, 0, 3], np.int64),
        "dst": np.asarray([1, 2, 0, 4, 5, 3, 2, 5], np.int64),
        "weight": np.ones(8, np.float64)})
    out["pic_clusters"] = PowerIterationClustering(
        k=2, max_iter=20).assign_clusters(ring).to_pydict()["cluster"].tolist()
    visits = Frame({"sequence": dq.list_column(
        [[["home"], ["search"], ["cart"]],
         [["home"], ["search"], ["cart"], ["buy"]],
         [["home"], ["cart"]],
         [["search"], ["cart"]]])})
    ps = PrefixSpan(min_support=0.5).find_frequent_sequential_patterns(
        visits).to_pydict()
    out["prefixspan"] = {"sequences": [[list(i) for i in s]
                                       for s in ps["sequence"]],
                         "freq": [int(f) for f in ps["freq"]]}
    spark.stop()
    return out


def rest_tour_errors(got: dict, want: dict = TOUR_REST_GOLDEN) -> dict:
    """Each float of ``rest_tour`` against the golden: |got − want|."""
    pairs = [("fm_intercept", got["fm_intercept"], want["fm_intercept"])]
    pairs += [(f"aft {k}", got["aft"][k], want["aft"][k])
              for k in ("coef", "intercept", "scale")]
    pairs += [(f"lsh {i}", a, b) for i, (a, b) in enumerate(
        zip(got["lsh_distances"], want["lsh_distances"]))]
    pairs += [(f"synonym {i}", a, b) for i, (a, b) in enumerate(
        zip(got["synonyms"]["similarity"], want["synonyms"]["similarity"]))]
    pairs.append(("lda log perplexity", got["lda_log_perplexity"],
                  want["lda_log_perplexity"]))
    return {name: abs(a - b) for name, a, b in pairs}


def check_rest_tour_golden(device: str) -> dict:
    """Phase 14(a): ``rest_tour`` against TOUR_REST_GOLDEN."""
    got = rest_tour(device)
    want = TOUR_REST_GOLDEN
    bad = [f"{k} {got[k]} vs {want[k]}" for k in REST_EXACT
           if got[k] != want[k]]
    if got["synonyms"]["words"][0] != want["synonyms"]["words"][0]:
        bad.append(f"top synonym {got['synonyms']}")
    if abs(got["iso_predict_30"] - want["iso_predict_30"]) > \
            REST_PREDICT_ATOL:
        bad.append(f"isotonic predict(30) {got['iso_predict_30']}")
    errs = rest_tour_errors(got)
    bad += [f"{k} off by {e}" for k, e in errs.items() if e > REST_ATOL]
    log(f"tour's second half on dataset-full, {device} float32: {got}; "
        f"errors against the JAX package {errs}")
    if bad:
        raise AssertionError(f"the tour's second half on dataset-full: {bad}")
    return {"result": got, "errors": errs}


def _zipf(m: int, s: float = 1.0) -> np.ndarray:
    p = 1.0 / np.arange(1, m + 1) ** s
    return p / p.sum()


def _ragged(rng, lengths, pool, p) -> list:
    """Lists of ``lengths`` draws from ``pool`` with probabilities ``p``."""
    flat = rng.choice(pool, size=int(lengths.sum()), p=p)
    return [list(x) for x in np.split(flat, np.cumsum(lengths)[:-1])]


def w2v_docs() -> list:
    """W2V_DOCS documents of 8-20 tokens over a W2V_WORDS-word vocabulary
    of W2V_TOPICS topics: a document draws its tokens from one topic's
    words (those equal to it modulo W2V_TOPICS) by Zipf rank. A corpus
    with no topics (one Zipf over all words) makes the SGD steps diverge
    at batch 4,096, in the JAX package's algorithm as in the port: its
    most frequent word takes about 500 summed updates a step."""
    rng = np.random.default_rng(4)
    words = np.array([f"w{j:04d}" for j in range(W2V_WORDS)], object)
    per = W2V_WORDS // W2V_TOPICS
    lens = rng.integers(8, 21, W2V_DOCS)
    topic = rng.integers(0, W2V_TOPICS, W2V_DOCS)
    ranks = rng.choice(per, size=int(lens.sum()), p=_zipf(per))
    ids = ranks * W2V_TOPICS + np.repeat(topic, lens)
    return [list(x) for x in np.split(words[ids], np.cumsum(lens)[:-1])]


def rest_data(rows: int = FULL_ROWS) -> dict:
    """Phase 14(b)'s seeded inputs, on the host: the tour's XOR points
    (two N(0, 1) columns, label x0·x1 > 0, target x0·x1 + N(0, 0.1)), its
    survival rows (20% censored), baskets of 2-6 of 50 Zipf items,
    sessions of 3-8 page itemsets (one page, or two in one of five) over 20
    pages, documents of 8-20 tokens (``w2v_docs``),
    binary rows for MinHash, and term counts of LDA_TOKENS tokens a
    document from LDA_TOPICS planted topics (each nine tenths on its own
    block of terms)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(rows, 2))
    xor = {"features": X, "label": (X[:, 0] * X[:, 1] > 0).astype(
        np.float64), "target": X[:, 0] * X[:, 1] + rng.normal(0.0, 0.1, rows)}
    rng = np.random.default_rng(1)
    a = rng.normal(size=rows)
    surv = {"features": a[:, None],
            "label": np.exp(1.0 + 0.3 * a + 0.4 * np.log(
                rng.exponential(size=rows))),
            "censor": (rng.random(rows) > 0.2).astype(np.float64)}
    rng = np.random.default_rng(2)
    items = np.array([f"i{j:02d}" for j in range(FP_ITEMS)], object)
    baskets = _ragged(rng, rng.integers(2, 7, FP_BASKETS), items,
                      _zipf(FP_ITEMS))
    rng = np.random.default_rng(3)
    pages = np.array([f"p{j:02d}" for j in range(PS_PAGES)], object)
    lens = rng.integers(3, 9, PS_SESSIONS)
    first = _ragged(rng, lens, pages, _zipf(PS_PAGES, 0.8))
    total = int(lens.sum())
    two = rng.random(total) < 0.2
    second = rng.choice(pages, size=total, p=_zipf(PS_PAGES, 0.8))
    flat = [sorted({f} | ({s} if t else set()))
            for f, s, t in zip((f for fs in first for f in fs), second, two)]
    sessions = [flat[s:e] for s, e in zip(np.cumsum(lens) - lens,
                                           np.cumsum(lens))]
    docs = w2v_docs()
    rng = np.random.default_rng(5)
    binary = rng.random((MINHASH_ROWS, MINHASH_COLS)) < 0.1
    binary[np.arange(MINHASH_ROWS),
           rng.integers(0, MINHASH_COLS, MINHASH_ROWS)] = True
    rng = np.random.default_rng(6)
    topic = rng.integers(0, LDA_TOPICS, LDA_DOCS)
    block = LDA_TERMS // LDA_TOPICS
    counts = np.zeros((LDA_DOCS, LDA_TERMS), np.int16)
    for k in range(LDA_TOPICS):
        p = np.full(LDA_TERMS, 0.1 / LDA_TERMS)
        p[k * block:(k + 1) * block] += 0.9 / block
        rows_k = np.flatnonzero(topic == k)
        terms = rng.choice(LDA_TERMS, size=(rows_k.size, LDA_TOKENS),
                           p=p / p.sum())
        counts[rows_k] = np.bincount(
            (np.arange(rows_k.size)[:, None] * LDA_TERMS + terms).ravel(),
            minlength=rows_k.size * LDA_TERMS).reshape(rows_k.size,
                                                       LDA_TERMS)
    return {"xor": xor, "surv": surv, "baskets": baskets,
            "sessions": sessions, "docs": docs,
            "binary": binary.astype(np.float64), "lda": counts,
            "planted_topics": topic}


def rest_frames(data: dict, clean, device: str) -> dict:
    """The frames of phase 14(b) on ``device`` in the float policy in
    force: the XOR rows (classification and regression), the survival
    rows, the clean table (if given) with isotonic's weight guest % 3 + 1,
    baskets,
    sessions, documents, the join's two halves, the binary rows and the
    LDA counts."""
    import torch

    from sparkdq4ml_tpu_torch.frame.frame import Frame
    from sparkdq4ml_tpu_torch.ops.cells import list_column

    x = data["xor"]
    xor = Frame({"features": x["features"], "label": x["label"]},
                device=device)
    join = x["features"][:2 * LSH_JOIN_ROWS]
    frames = {} if clean is None else {"iso": clean.with_column(
        "w", (clean.col("guest") % 3 + 1).cast("double"))}
    return {**frames,
        "xor": xor,
        "xor_reg": xor.with_column("label", x["target"]),
        "surv": Frame(dict(data["surv"]), device=device),
        "baskets": Frame({"items": list_column(data["baskets"])},
                         device=device),
        "sessions": Frame({"sequence": list_column(data["sessions"])},
                          device=device),
        "docs": Frame({"toks": list_column(data["docs"])}, device=device),
        "join_a": Frame({"features": join[:LSH_JOIN_ROWS]}, device=device),
        "join_b": Frame({"features": join[LSH_JOIN_ROWS:]}, device=device),
        "binary": Frame({"features": data["binary"]}, device=device),
        "lda": Frame({"features": torch.as_tensor(
            data["lda"], device=device)}, device=device)}


def rest_fits(data: dict):
    """(name, fn(frames) -> host results) of phase 14(b), in order."""
    from sparkdq4ml_tpu_torch.models import (AFTSurvivalRegression,
                                             BucketedRandomProjectionLSH,
                                             FMClassifier, FMRegressor,
                                             FPGrowth, IsotonicRegression,
                                             LDA, MinHashLSH, PrefixSpan,
                                             Word2Vec)

    def fm(est, frame, accuracy):
        m = est.fit(frame)
        out = {"intercept": m.intercept, "linear": m.linear,
               "factors": m.factors, "loss": m.loss_history[-1]}
        if accuracy:
            out["accuracy"] = _valid_share(m.transform(frame), "prediction",
                                           "label")
        return out

    def iso(f, **kw):
        m = IsotonicRegression(features_col="guest", label_col="price",
                               **kw).fit(f["iso"])
        return {"boundaries": m.boundaries, "predictions": m.predictions}

    def w2v(f):
        m = Word2Vec(vector_size=100, window_size=5, min_count=5, max_iter=1,
                     batch_size=4096, seed=1, input_col="toks",
                     output_col="vec").fit(f["docs"])
        means = m.transform(f["docs"])._column_values("vec")
        out = {"vectors": m.vectors, "loss": np.asarray(m.loss_history),
               "means_sum": float(means.double().abs().sum()),
               "vocabulary": np.asarray(m.vocabulary)}
        for w in m.vocabulary[:20]:
            s = m.find_synonyms(w, 2).to_pydict()
            out[f"syn {w}"] = np.asarray([m._index[v] for v in s["word"]])
            out[f"sim {w}"] = np.asarray(s["similarity"])
        return out

    def ann(f):
        m = BucketedRandomProjectionLSH(bucket_length=2.0, num_hash_tables=4,
                                        seed=3).fit(f["xor"])
        X = data["xor"]["features"]
        out = {"hashes": m.transform(f["xor"])._column_values("hashes")[
            :LSH_HASH_ROWS].cpu().numpy(), "projections": m.projections}
        for q in range(ANN_QUERIES):
            r = m.approx_nearest_neighbors(f["xor"], X[q], 5).to_pydict()
            order = np.argsort(r["distCol"], kind="stable")
            out[f"dist {q}"] = np.asarray(r["distCol"])[order]
        return out

    def join(f):
        m = BucketedRandomProjectionLSH(bucket_length=0.05, num_hash_tables=4,
                                        seed=3).fit(f["join_a"])
        r = m.approx_similarity_join(f["join_a"], f["join_b"], 0.01
                                     ).to_pydict()
        return {"idA": r["idA"], "idB": r["idB"], "dist": r["distCol"],
                "hashes_a": m.transform(f["join_a"])._column_values(
                    "hashes").cpu().numpy(),
                "hashes_b": m.transform(f["join_b"])._column_values(
                    "hashes").cpu().numpy(), "projections": m.projections}

    def minhash(f):
        m = MinHashLSH(num_hash_tables=4, seed=3).fit(f["binary"])
        r = m.approx_nearest_neighbors(f["binary"], data["binary"][0], 5
                                       ).to_pydict()
        return {"hashes": m.transform(f["binary"])._column_values(
            "hashes").cpu().numpy(), "dist": np.sort(r["distCol"]),
            "coeff_a": m.coeff_a, "coeff_b": m.coeff_b}

    def lda(f, optimizer, max_iter):
        m = LDA(k=LDA_TOPICS, max_iter=max_iter, optimizer=optimizer,
                seed=1).fit(f["lda"])
        return {"topics": m.topics, "perplexity": m.log_perplexity(f["lda"]),
                "top_terms": np.stack(m.describe_topics(5).to_pydict()[
                    "termIndices"])}

    return [
        ("fm_classifier", lambda f: fm(FMClassifier(
            factor_size=4, max_iter=400, step_size=0.05, seed=1),
            f["xor"], True)),
        ("fm_regressor", lambda f: fm(FMRegressor(factor_size=4,
                                                  max_iter=200),
                                      f["xor_reg"], False)),
        ("aft", lambda f: (lambda m: {
            "coef": m.coefficients, "intercept": m.intercept,
            "scale": m.scale, "loss": m.loss_history[-1]})(
                AFTSurvivalRegression(max_iter=300).fit(f["surv"]))),
        ("isotonic", lambda f: iso(f)),
        ("isotonic_antitonic", lambda f: iso(f, isotonic=False)),
        ("isotonic_weighted", lambda f: iso(f, weight_col="w")),
        ("fpgrowth", lambda f: (lambda m: {
            "itemsets": np.asarray([" ".join(s) for s, _ in m.itemsets]),
            "counts": np.asarray([c for _, c in m.itemsets]),
            "rules": len(m.association_rules.to_pydict()["confidence"])})(
                FPGrowth(min_support=0.01, min_confidence=0.5).fit(
                    f["baskets"]))),
        ("prefixspan", lambda f: (lambda d: {
            "patterns": np.asarray(["|".join(" ".join(i) for i in s)
                                    for s in d["sequence"]]),
            "freq": np.asarray(d["freq"])})(PrefixSpan(
                min_support=0.05).find_frequent_sequential_patterns(
                    f["sessions"]).to_pydict())),
        ("word2vec", w2v),
        ("lsh_ann", ann),
        ("lsh_join", join),
        ("minhash", minhash),
        ("lda_em", lambda f: lda(f, "em", 25)),
        ("lda_online", lambda f: lda(f, "online", 50)),
    ]


# The fits whose float64 reference runs on the card under the float64
# policy (the others are held against independent numpy code).
REST_CARD_REFERENCE = ("fm_classifier", "fm_regressor", "aft", "word2vec",
                       "lda_em", "lda_online")


class float32_draws:
    """Within the block, the random draws of the float64 reference are the
    float32 run's: JAX's normal and gamma drawn in float32 and widened,
    randint in int32, and Word2Vec's negatives from float32 uniforms into
    the float32 CDF (x64 would draw other numbers from the same keys)."""

    def __enter__(self):
        import torch

        from sparkdq4ml_tpu_torch.models import word2vec
        from sparkdq4ml_tpu_torch.utils import prng

        self.saved = [(prng, "normal", prng.normal),
                      (prng, "gamma", prng.gamma),
                      (prng, "randint", prng.randint),
                      (word2vec, "step_negatives", word2vec.step_negatives)]
        normal, gamma, randint, negatives = (s[2] for s in self.saved)
        prng.normal = lambda key, shape=(), dtype=torch.float32: normal(
            key, shape, torch.float32).to(dtype)
        prng.gamma = lambda key, a, shape, dtype=torch.float32: gamma(
            key, a, shape, torch.float32).to(dtype)
        prng.randint = lambda key, shape, lo, hi, dtype=torch.int32: \
            randint(key, shape, lo, hi, torch.int32).to(dtype)
        word2vec.step_negatives = lambda cdf, *a: negatives(
            cdf.to(torch.float32), *a[:-1], torch.float32)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def _np_threefry(k1, k2, x0, x1):
    """Threefry-2x32 in numpy uint32 (20 rounds): JAX's PRNG hash."""
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (np.uint32(k1), np.uint32(k2),
          np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA))
    x = [x0 + ks[0], x1 + ks[1]]
    for i in range(5):
        for r in rot[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def numpy_negatives(cdf32, seed: int, step: int, shape) -> np.ndarray:
    """One Word2Vec step's negatives in numpy: ``fold_in(PRNGKey(seed),
    step)``, JAX's float32 uniforms of ``shape`` under that key, and
    ``searchsorted`` into the float32 CDF."""
    with np.errstate(over="ignore"):
        k = _np_threefry((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF,
                         np.uint32([0]), np.uint32([step]))
        n = int(np.prod(shape))
        idx = np.arange(n, dtype=np.uint64)
        b1, b2 = _np_threefry(k[0][0], k[1][0],
                              (idx >> np.uint64(32)).astype(np.uint32),
                              (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = ((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)
    u = bits.view(np.float32) - np.float32(1.0)
    return np.searchsorted(cdf32, u).reshape(shape)


def numpy_isotonic(x, y, w, isotonic: bool = True, order=None):
    """Isotonic regression in numpy float64: a stable argsort (``order``
    if given), the weighted sums by distinct value with
    ``np.add.reduceat``, then pool-adjacent-violators as a list of merged
    blocks. Returns (boundaries, predictions)."""
    sign = 1.0 if isotonic else -1.0
    if order is None:
        order = np.argsort(x, kind="stable")
    xs, ys, ws = x[order], sign * y[order], w[order]
    start = np.flatnonzero(np.concatenate([[True], xs[1:] != xs[:-1]]))
    uniq = xs[start]
    wsum = np.add.reduceat(ws, start)
    ysum = np.add.reduceat(ws * ys, start)
    keep = wsum > 0
    blocks = []                     # [value, weight, low x, high x]
    for xv, yv, wv in zip(uniq[keep], ysum[keep] / wsum[keep], wsum[keep]):
        blocks.append([yv, wv, xv, xv])
        while len(blocks) > 1 and blocks[-2][0] > blocks[-1][0]:
            b = blocks.pop()
            a = blocks[-1]
            a[0] = (a[0] * a[1] + b[0] * b[1]) / (a[1] + b[1])
            a[1] += b[1]
            a[3] = b[3]
    bx = [v for a in blocks for v in ((a[2], a[3]) if a[3] != a[2]
                                      else (a[2],))]
    by = [a[0] for a in blocks for _ in range(1 + (a[3] != a[2]))]
    return np.asarray(bx), sign * np.asarray(by)


def numpy_itemsets(baskets, min_support: float) -> dict:
    """Every frequent itemset's support, by brute force on a basket × item
    matrix: the sets grow one item at a time (items in name order), and a
    set is counted as the number of baskets holding all its items."""
    names = sorted({i for b in baskets for i in b})
    col = {n: j for j, n in enumerate(names)}
    M = np.zeros((len(baskets), len(names)), np.float32)
    for r, b in enumerate(baskets):
        M[r, [col[i] for i in b]] = 1.0
    min_count = max(1, int(np.ceil(min_support * len(baskets))))
    out, frontier = {}, [((), np.ones(len(baskets), np.float32))]
    while frontier:
        nxt = []
        for items, rows in frontier:
            counts = rows @ M
            last = col[items[-1]] if items else -1
            for j in range(last + 1, len(names)):
                if counts[j] >= min_count:
                    s = items + (names[j],)
                    out[" ".join(s)] = int(counts[j])
                    nxt.append((s, rows * M[:, j]))
        frontier = nxt
    return out


def numpy_sequences(sessions, min_support: float, max_len: int = 10):
    """Every frequent sequential pattern's support, by brute force: a
    pattern is contained in a session where its itemsets are subsets of
    the session's itemsets at increasing positions (earliest match), each
    page held as a bit mask of the positions a session has it at; the
    patterns grow by a new itemset or by a page past the last itemset's
    largest."""
    pages = sorted({p for s in sessions for i in s for p in i})
    L = max(len(s) for s in sessions)
    if L > 62:
        raise ValueError("numpy_sequences: sessions of at most 62 itemsets")
    at = {p: np.zeros(len(sessions), np.int64) for p in pages}
    for r, s in enumerate(sessions):
        for q, items in enumerate(s):
            for p in set(items):
                at[p][r] |= 1 << q
    min_count = max(1, int(np.ceil(min_support * len(sessions))))

    def support(pattern):
        after = np.zeros(len(sessions), np.int64)      # positions still open
        after -= 1
        for items in pattern:
            hit = after.copy()
            for p in items:
                hit &= at[p]
            first = hit & -hit                         # lowest position left
            after = np.where(hit != 0, ~((first << 1) - 1), 0)
        return int((after != 0).sum() if pattern else 0)

    out, frontier = {}, [[]]
    while frontier:
        nxt = []
        for pattern in frontier:
            if sum(len(i) for i in pattern) >= max_len:
                continue
            grown = [pattern + [[p]] for p in pages]
            if pattern:
                grown += [pattern[:-1] + [pattern[-1] + [p]] for p in pages
                          if p > pattern[-1][-1]]
            for g in grown:
                c = support(g)
                if c >= min_count:
                    out["|".join(" ".join(i) for i in g)] = c
                    nxt.append(g)
        frontier = nxt
    return out


def numpy_pairs(ha, hb) -> np.ndarray:
    """The (a, b) row pairs that share a bucket in any table, as the keys
    a·len(b) + b, unique and ascending: per table both sides sorted by
    bucket and each a row paired with the b rows of its bucket."""
    keys = []
    for t in range(ha.shape[1]):
        oa = np.argsort(ha[:, t], kind="stable")
        ob = np.argsort(hb[:, t], kind="stable")
        ka, kb = ha[oa, t], hb[ob, t]
        lo = np.searchsorted(kb, ka, "left")
        cnt = np.searchsorted(kb, ka, "right") - lo
        within = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt,
                                                       cnt)
        keys.append(np.repeat(oa, cnt) * len(hb) + ob[np.repeat(lo, cnt)
                                                      + within])
    keys = np.sort(np.concatenate(keys))
    return keys[np.concatenate([[True], keys[1:] != keys[:-1]])]


def over(err, tol) -> bool:
    """True where ``err`` exceeds ``tol`` or is NaN."""
    return not err <= tol


def rel_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))) \
        if a.size else 0.0


def rest_reference_checks(card: dict, data: dict, clean_cols: tuple,
                          device: str = "cuda") -> dict:
    """Phase 14(c)'s gates against independent code: numpy for isotonic's
    three fits, FPGrowth's itemsets and PrefixSpan's patterns and counts,
    the LSH join and MinHash; plain torch float64 on ``device`` for the LSH
    hashes and nearest neighbors over the 10^7 points (in numpy they took
    11 s of the card's host)."""
    import torch

    bad, notes = [], {"seconds": {}}
    mark = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        notes["seconds"][name] = now - mark[0]
        mark[0] = now

    guest, price = (np.asarray(c, np.float64) for c in clean_cols)
    order = np.argsort(guest, kind="stable")
    for name, kw in (("isotonic", {}), ("isotonic_antitonic",
                                        {"isotonic": False}),
                     ("isotonic_weighted", {"w": guest % 3 + 1})):
        w = kw.pop("w", np.ones_like(guest))
        bx, by = numpy_isotonic(guest, price, w, order=order, **kw)
        got = card[name]
        if not np.array_equal(got["boundaries"], bx):
            bad.append(f"{name} boundaries {got['boundaries']} vs {bx}")
        elif over(np.max(np.abs(got["predictions"] - by)),
                  ISO_PREDICT_TOL):
            bad.append(f"{name} predictions off by "
                       f"{np.max(np.abs(got['predictions'] - by))}")
        notes[name] = {"boundaries": int(bx.size)}
    lap("isotonic")
    want = numpy_itemsets(data["baskets"], 0.01)
    got = dict(zip(card["fpgrowth"]["itemsets"].tolist(),
                   card["fpgrowth"]["counts"].tolist()))
    if got != want:
        bad.append(f"fpgrowth itemsets: {len(got)} vs numpy's {len(want)}")
    notes["fpgrowth"] = {"itemsets": len(want),
                         "rules": card["fpgrowth"]["rules"]}
    lap("itemsets")
    want = numpy_sequences(data["sessions"], 0.05)
    got = dict(zip(card["prefixspan"]["patterns"].tolist(),
                   card["prefixspan"]["freq"].tolist()))
    if got != want:
        bad.append(f"prefixspan patterns: {len(got)} vs numpy's {len(want)}")
    notes["prefixspan"] = {"patterns": len(want)}
    lap("patterns")

    X = torch.as_tensor(data["xor"]["features"], device=device)
    ann = card["lsh_ann"]
    length = torch.tensor(2.0, dtype=torch.float64, device=device)
    proj = X @ torch.as_tensor(ann["projections"], device=device) / length
    hx = torch.floor(proj).to(torch.int64)
    head = proj[:LSH_HASH_ROWS]
    edge = (head - torch.round(head)).abs().cpu().numpy()
    hx_head = hx[:LSH_HASH_ROWS].cpu().numpy()
    off = (ann["hashes"] != hx_head) & (edge > LSH_EDGE)
    if off.any():
        bad.append(f"lsh hashes: {int(off.sum())} differ away from an edge")
    notes["lsh_hash_rows_at_edges"] = int(
        (ann["hashes"] != hx_head).any(axis=1).sum())
    x32 = X.float().double()
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=device)
    worst = 0.0
    for q in range(ANN_QUERIES):
        cand = (hx == hx[q]).any(dim=1)
        d2 = torch.where(cand, ((x32 - x32[q]) ** 2).sum(dim=1), inf)
        d = torch.sqrt(torch.topk(d2, 5, largest=False).values).cpu().numpy()
        worst = max(worst, float(np.max(np.abs(ann[f"dist {q}"] - d))))
    if over(worst, LSH_DIST_TOL):
        bad.append(f"lsh nearest-neighbor distances off by {worst}")
    notes["lsh_ann_max_err"] = worst
    del X, proj, hx, x32
    x32 = data["xor"]["features"][:2 * LSH_JOIN_ROWS].astype(
        np.float32).astype(np.float64)
    lap("lsh_ann")
    j = card["lsh_join"]
    keys = numpy_pairs(j["hashes_a"].astype(np.int64),
                       j["hashes_b"].astype(np.int64))
    a, b = keys // LSH_JOIN_ROWS, keys % LSH_JOIN_ROWS
    xa = x32[:LSH_JOIN_ROWS]
    xb = x32[LSH_JOIN_ROWS:2 * LSH_JOIN_ROWS]
    d = np.sqrt(((xa[a] - xb[b]) ** 2).sum(axis=1))
    near = np.abs(d - 0.01) <= 1e-6             # at the threshold: printed
    want = set(zip(a[(d <= 0.01) & ~near].tolist(),
                   b[(d <= 0.01) & ~near].tolist()))
    got = set(zip(j["idA"].tolist(), j["idB"].tolist()))
    at_threshold = set(zip(a[near].tolist(), b[near].tolist()))
    if (got - at_threshold) != want:
        bad.append(f"lsh join: {len(got)} pairs vs numpy's {len(want)}")
    notes["lsh_join"] = {"candidates": int(keys.size), "pairs": len(got),
                         "at_threshold": len(at_threshold)}

    lap("lsh_join")
    m = card["minhash"]
    B = data["binary"]
    prime = 2038074743
    hv = (m["coeff_a"][:, None] * np.arange(1, B.shape[1] + 1)[None, :]
          + m["coeff_b"][:, None]) % prime
    hm = np.where(B[:, None, :] > 0, hv[None], prime).min(axis=2)
    if not np.array_equal(m["hashes"].astype(np.int64), hm):
        bad.append("minhash hashes differ from numpy's")
    cand = (hm == hm[0]).any(axis=1)
    inter = (B[cand] * B[0]).sum(axis=1)
    union = ((B[cand] + B[0]) > 0).sum(axis=1)
    d = np.sort(1.0 - inter / np.maximum(union, 1))[:5]
    if over(np.max(np.abs(m["dist"] - d)), LSH_DIST_TOL):
        bad.append(f"minhash distances {m['dist']} vs {d}")
    lap("minhash")
    if bad:
        raise AssertionError(f"phase 14 against numpy: {bad}")
    return notes


def check_rest_card(card: dict, ref: dict, launches: dict, data: dict,
                    steps: int) -> dict:
    """Phase 14(c)'s gates against the float64 run on the card (FM, AFT,
    Word2Vec, LDA) and the launch counts; returns the errors and the
    near ties printed."""
    bad, out = [], {}
    for name in ("fm_classifier", "fm_regressor"):
        e = rel_gap(card[name]["loss"], ref[name]["loss"])
        out[f"{name} loss"] = e
        if over(e, FM_LOSS_RTOL):
            bad.append(f"{name} loss {card[name]['loss']} vs "
                       f"{ref[name]['loss']}")
    acc = abs(card["fm_classifier"]["accuracy"]
              - ref["fm_classifier"]["accuracy"])
    out["fm accuracy"] = acc
    if over(acc, FM_ACCURACY_TOL):
        bad.append(f"fm accuracy off by {acc}")
    for k in ("coef", "intercept", "scale"):
        e = float(np.max(np.abs(np.asarray(card["aft"][k], np.float64)
                                - np.asarray(ref["aft"][k], np.float64))))
        out[f"aft {k}"] = e
        if over(e, AFT_TOL):
            bad.append(f"aft {k} off by {e}")
    w, wr = card["word2vec"], ref["word2vec"]
    if not (np.all(np.isfinite(w["vectors"])) and np.all(np.isfinite(
            w["loss"]))):
        bad.append("word2vec vectors or losses not finite")
    e = rel_gap(w["loss"][-1], wr["loss"][-1])
    out["word2vec last loss"] = e
    if over(e, W2V_LOSS_RTOL):
        bad.append(f"word2vec last loss {w['loss'][-1]} vs {wr['loss'][-1]}")
    ties = []
    for word in wr["vocabulary"][:20]:
        sims = wr[f"sim {word}"]
        lead = float(sims[0] - sims[1])
        same = w[f"syn {word}"][0] == wr[f"syn {word}"][0]
        if not lead > W2V_MARGIN:
            ties.append({"word": str(word), "lead": lead, "same": bool(same)})
        elif not same:
            bad.append(f"word2vec top synonym of {word}")
    out["word2vec near ties"] = ties
    for name in ("lda_em", "lda_online"):
        g, r = card[name], ref[name]
        # each topic's λ against its largest entry: an entry near η holds
        # a few tokens, whose float32 sums round at 1e-4 of themselves
        e = float(np.max(np.abs(g["topics"] - r["topics"])
                         / np.max(r["topics"], axis=1, keepdims=True)))
        out[f"{name} lambda"] = e
        if over(e, LDA_RTOL):
            bad.append(f"{name} lambda off by {e} relative")
        e = rel_gap(g["perplexity"], r["perplexity"])
        out[f"{name} perplexity"] = e
        if over(e, LDA_RTOL):
            bad.append(f"{name} perplexity {g['perplexity']} vs "
                       f"{r['perplexity']}")
        beta = r["topics"] / r["topics"].sum(axis=1, keepdims=True)
        srt = -np.sort(-beta, axis=1)
        gap = np.minimum(np.diff(-srt, axis=1, prepend=-np.inf)[:, :5],
                         np.diff(-srt, axis=1)[:, :5]) / srt[:, :5]
        held = gap > LDA_MARGIN
        if np.any((g["top_terms"] != r["top_terms"]) & held):
            bad.append(f"{name} top terms {g['top_terms']} vs "
                       f"{r['top_terms']}")
        out[f"{name} near ties"] = int((~held).sum())
    for name in ("isotonic", "isotonic_antitonic", "isotonic_weighted"):
        if launches[name]["sorted_segment_sum"] != 1:
            bad.append(f"{name} launches {launches[name]}")
    if launches["word2vec"]["sorted_segment_sum"] != 2 * steps + 1:
        bad.append(f"word2vec launches {launches['word2vec']} for {steps} "
                   "steps")
    if bad:
        raise AssertionError(f"phase 14 gates: {bad}")
    return out


def check_negatives(cdf32, seed: int, steps: int, batch: int,
                    negatives: int = 5, device: str = "cuda") -> list:
    """Word2Vec's negatives on the card (``word2vec.step_negatives``, the
    fit's own draw) bit for bit against numpy's threefry, at
    W2V_NEGATIVE_STEPS steps spread over the fit."""
    import torch

    from sparkdq4ml_tpu_torch.models import word2vec

    cdf = torch.as_tensor(cdf32, device=device)
    picks = sorted({int(s) for s in np.linspace(0, steps - 1,
                                                W2V_NEGATIVE_STEPS)})
    for s in picks:
        got = word2vec.step_negatives(cdf, seed, s, s + 1, batch, negatives,
                                      torch.float32)[0].cpu().numpy()
        if not np.array_equal(got, numpy_negatives(cdf32, seed, s,
                                                   (batch, negatives))):
            raise AssertionError(f"word2vec negatives of step {s} differ "
                                 "from numpy's threefry draw")
    return picks


def w2v_cdf(docs, min_count: int = 5) -> np.ndarray:
    """The float32 unigram^0.75 CDF of the vocabulary Word2Vec builds."""
    from sparkdq4ml_tpu_torch.models import word2vec

    _, counts, _ = word2vec._build_vocab(docs, np.ones(len(docs), bool),
                                         min_count, 262144)
    p = counts.astype(np.float64) ** 0.75
    return np.cumsum(p / p.sum()).astype(np.float32)


def check_rest_full(rows: int = FULL_ROWS) -> dict:
    """Phase 14(b)-(c): the fits of ``rest_fits`` on the card in float32,
    each twice (bit-identical) with the launch counts set to 0 just before
    it and read just after, isotonic on the table cleaned by one dq_rules
    launch, one Word2Vec fit under torch.profiler; then the float64 run of
    FM, AFT, Word2Vec and LDA on the card under the float64 policy with
    the float32 run's draws (``float32_draws``), the numpy references of
    the rest, and the gates."""
    import torch

    from sparkdq4ml_tpu_torch.config import float_policy
    from sparkdq4ml_tpu_torch.ops import kernels
    from sparkdq4ml_tpu_torch.ops.cells import list_column

    t0 = time.perf_counter()
    data = rest_data(rows)
    guest, price = full_table(rows)
    data_s = time.perf_counter() - t0
    fits = rest_fits(data)
    t_card = time.perf_counter()
    torch.cuda.synchronize()
    kernels.launches.reset()
    spark, clean = clean_table("cuda", guest, price)
    torch.cuda.synchronize()
    clean_counts = kernels.launches.snapshot()
    if clean_counts["dq_rules"] != 1:
        raise AssertionError(f"phase 14's clean table: {clean_counts}")
    clean_host = clean.to_pydict()
    clean_cols = (clean_host["guest"], clean_host["price"])
    frames = rest_frames(data, clean, "cuda")
    card, launches, fit_ms, differ = {}, {}, {}, {}
    for name, fn in fits:
        card[name], launches[name], s1 = driven(fn, frames)
        again, _, s2 = driven(fn, frames)
        differ[name] = same_results(card[name], again)
        fit_ms[name] = [1e3 * s1, 1e3 * s2]
    profiled = {}
    profiles = {"word2vec": profile_run(
        "rest_word2vec", lambda: profiled.update(dict(fits)["word2vec"](
            {"docs": frames["docs"].filter(torch.arange(
                W2V_DOCS, device="cuda") < W2V_PROFILED_DOCS)})))}
    profiles["word2vec"]["steps"] = len(profiled["loss"])
    del frames
    spark.stop()
    card_s = time.perf_counter() - t_card
    bad = {k: v for k, v in differ.items() if v}
    if bad:
        raise AssertionError(f"phase 14 fits differ between two card runs: "
                             f"{bad}")
    steps = len(card["word2vec"]["loss"])
    t0 = time.perf_counter()
    with float_policy(torch.float64), float32_draws():
        frames64 = rest_frames(data, None, "cuda")
        ref, ref_fit_s = {}, {}
        for name, fn in fits:
            if name in REST_CARD_REFERENCE:
                ref[name], _, ref_fit_s[name] = driven(fn, frames64)
        del frames64
    torch.cuda.synchronize()
    ref_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gates = check_rest_card(card, ref, launches, data, steps)
    numpy_notes = rest_reference_checks(card, data, clean_cols)
    t1 = time.perf_counter()
    picks = check_negatives(w2v_cdf(list_column(data["docs"])), 1, steps,
                            4096)
    numpy_notes["seconds"]["negatives"] = time.perf_counter() - t1
    ref_numpy_s = time.perf_counter() - t0
    w2v_prof = profiles["word2vec"]
    seg_ms = w2v_prof.get("port_kernel_ms", {}).get("sorted_segment_sum")
    summary = {
        "fm_classifier": {k: card["fm_classifier"][k]
                          for k in ("intercept", "loss", "accuracy")},
        "fm_regressor": {k: card["fm_regressor"][k]
                         for k in ("intercept", "loss")},
        "aft": {"coef": card["aft"]["coef"].tolist(),
                "intercept": card["aft"]["intercept"],
                "scale": card["aft"]["scale"]},
        "isotonic": numpy_notes, "word2vec": {
            "steps": steps, "last_loss": float(card["word2vec"]["loss"][-1]),
            "negatives_checked_at_steps": picks,
            "segment_sum_device_ms_per_step": (
                None if seg_ms is None
                else seg_ms / w2v_prof["steps"])},
        "lda": {name: {"perplexity": card[name]["perplexity"],
                       "top_terms": card[name]["top_terms"].tolist()}
                for name in ("lda_em", "lda_online")}}
    log(f"phase 14 at {rows} rows ({len(clean_cols[0])} clean): "
        f"{json.dumps(summary, default=str)}; fit ms {fit_ms}; gates "
        f"{json.dumps(gates, default=str)}; profiles {profiles}; float64 "
        f"reference on the card {ref_card_s:.1f} s, numpy {ref_numpy_s:.1f} s")
    return {"rows": rows, "clean_rows": len(clean_cols[0]), "fits": summary,
            "fit_ms": fit_ms, "launches": launches,
            "clean_launches": clean_counts, "gates": gates,
            "numpy": numpy_notes, "profiles": profiles,
            "float64_on_card": REST_CARD_REFERENCE,
            "float64_fit_s": ref_fit_s, "data_s": data_s,
            "card_s": card_s, "card_float64_reference_s": ref_card_s,
            "numpy_reference_s": ref_numpy_s}


def rest_segment_cases():
    """(name, kernel, x, seg, size) at phase 14's segment-sum shapes:
    Word2Vec's step updates (4,096 center rows and 4,096·6 context and
    negative rows of 100 columns onto 2,000 slots, the ids sorted first as
    ops/segments.py does), its document means (the token rows of 10^5
    documents onto one slot a document, in document order), and
    isotonic's (w, w·y) in float64 over the clean rows sorted by guest
    onto 39 slots."""
    import torch

    rng = np.random.default_rng(7)
    p = _zipf(W2V_WORDS)
    cases = []
    for name, n in (("word2vec dU", 4096), ("word2vec dV", 4096 * 6)):
        ids = torch.as_tensor(rng.choice(W2V_WORDS, n, p=p), device="cuda")
        order = torch.sort(ids, stable=True)
        x = torch.randn((n, 100), device="cuda", dtype=torch.float32,
                        generator=torch.Generator("cuda").manual_seed(n))
        cases.append((name, "sorted_segment_sum",
                      x.index_select(0, order.indices), order.values,
                      W2V_WORDS))
    lens = np.asarray([len(d) for d in w2v_docs()])
    docs = torch.as_tensor(np.repeat(np.arange(lens.size), lens),
                           device="cuda")
    cases.append(("word2vec document means", "sorted_segment_sum",
                  torch.randn((int(lens.sum()), 100), device="cuda",
                              generator=torch.Generator("cuda").manual_seed(
                                  3)), docs, lens.size))
    guest, price = clean_columns()
    by_guest = torch.sort(guest, stable=True)
    w = (guest % 3 + 1).to(torch.float64).index_select(0, by_guest.indices)
    y = price.to(torch.float64).index_select(0, by_guest.indices)
    first = torch.ones_like(by_guest.values, dtype=torch.bool)
    first[1:] = by_guest.values[1:] != by_guest.values[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    cases.append(("isotonic (w, w·y) float64", "sorted_segment_sum",
                  torch.stack([w, w * y], dim=1), seg, int(seg[-1]) + 1))
    return cases


# ---------------------------------------------------------------------------
# Phase 15: the feature layer and spark.ml.stat at 10^7 rows
# ---------------------------------------------------------------------------

FEATURE_TIERS = ("low", "mid", "high")     # the price band (BAND_PRICES)
FEATURE_HOLE_EVERY = 7                     # slot i % 7 == 3: price is NaN
FEATURE_GUEST_SPLITS = [-float("inf"), 10.0, 20.0, 30.0, float("inf")]
FEATURE_BUCKETS = 10
FEATURE_PCA_K = 3
FEATURE_TOP = 5
FEATURE_VARIANCE = 0.5
FEATURE_REG = 0.1
FEATURE_DERIVED = "SELECT *, price_imp * guest AS spend FROM __THIS__"
FEATURE_FORMULA = "l2 ~ tier + guest + price_imp + spend"
# Card float32 against the CPU float64 run of the same steps on the same
# rows: moments, norms, scaler statistics, chi-square statistics and
# explained variance within 1e-4 relative (float32 sums of 10^7 rows, as
# SQL_ROWS_RTOL); correlations and the scaled means within 1e-4 absolute
# (the correlations lie in [-1, 1], the scaled columns have mean 0 and
# std 1); PCA components within 1e-3 absolute where the float64
# eigen-gap to their neighbours exceeds FEATURE_PCA_GAP of the largest
# eigenvalue (the others printed); nonzero counts within 1e-6 relative;
# the classifier as phase 9's (CLASSIFIER_RTOL, OBJECTIVE_RTOL,
# ITERATION_SLACK). Exact: labels, sizes, surrogates, bucket counts and
# splits (order statistics of the same float32 values, numpy's
# interpolation in float64 on both sides), counts, degrees of freedom,
# selections, RFormula's columns.
FEATURE_RTOL = 1e-4
FEATURE_ATOL = 1e-4
FEATURE_PCA_ATOL = 1e-3
FEATURE_PCA_GAP = 1e-2
FEATURE_NNZ_RTOL = 1e-6
FEATURE_KERNELS = ("dq_rules", "dense_segment_sum", "masked_gram")


def feature_columns(guest, price) -> dict:
    """Phase 15's host columns: price rounded to float32 (the card's
    values, so the float64 reference reads the same rows), the same price
    with every FEATURE_HOLE_EVERY-th slot NaN, and the band's tier string
    (a host column)."""
    p32 = price.astype(np.float32)
    band = (p32 >= BAND_PRICES[0]).astype(np.int8) + (p32 >= BAND_PRICES[1])
    holed = np.where(np.arange(len(price)) % FEATURE_HOLE_EVERY == 3,
                     np.float32(np.nan), p32)
    return {"guest": guest, "price": p32.astype(np.float64),
            "price_holed": holed.astype(np.float64),
            "tier": np.asarray(FEATURE_TIERS, object)[band]}


def feature_frame(df):
    """``df`` with phase 9's labels l2 (price > 102.5) and band."""
    price = df.col("price")
    return df.with_columns({
        "l2": (price > 102.5).cast("double"),
        "band": ((price >= BAND_PRICES[0]).cast("double")
                 + (price >= BAND_PRICES[1]).cast("double"))})


def _valid_host(frame, col: str) -> np.ndarray:
    """A column's valid rows on the host (a frame of either package)."""
    v, m = frame._column_values(col), frame.mask
    if hasattr(v, "cpu"):
        return v[m].cpu().numpy()
    return np.asarray(v)[np.asarray(m)]


def _canon(v, dtypes: bool = True):
    """A step's results as plain JSON values, exact (floats by repr):
    equal canons are bit-identical results (with ``dtypes``, of the same
    array types)."""
    if isinstance(v, dict):
        return {k: _canon(x, dtypes) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return [v.dtype.str, v.tolist()] if dtypes else v.tolist()
    if isinstance(v, (list, tuple)):
        return [_canon(x, dtypes) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def same_canon(a, b, dtypes: bool = True) -> bool:
    return json.dumps(_canon(a, dtypes)) == json.dumps(_canon(b, dtypes))


def _lr_numbers(model) -> dict:
    s = model.summary
    return {"coef": np.ravel(np.asarray(model.coefficient_matrix)).tolist(),
            "intercept": np.ravel(np.asarray(model.intercept_vector))
            .tolist(),
            "iterations": int(s.total_iterations),
            "objective": float(s.objective_history[-1])}


def feature_steps(M, tmp: str):
    """(name, fn(state) -> host results) of phase 15, in order, over the
    models module ``M`` (the port's; the CPU tests pass the JAX package's
    too). ``state["df"]`` is the running frame, ``state["base"]`` the
    clean table the RFormula pipeline starts from."""
    def fit_transform(s, est):
        model = est.fit(s["df"])
        s["df"] = model.transform(s["df"])
        return model

    def counts(s, col, size):
        v = _valid_host(s["df"], col)
        return np.bincount(v.astype(np.int64), minlength=size)

    def index(s):
        return {"labels": list(fit_transform(
            s, M.StringIndexer("tier", "tier_idx")).labels)}

    def onehot(s):
        return {"sizes": fit_transform(
            s, M.OneHotEncoder("tier_idx", "tier_vec")).categorySizes}

    def impute(s):
        return {"surrogates": fit_transform(s, M.Imputer(
            ["price_holed"], ["price_imp"], strategy="median")).surrogates}

    def bucketize(s):
        s["df"] = M.Bucketizer(FEATURE_GUEST_SPLITS, "guest",
                               "guest_bucket").transform(s["df"])
        return {"counts": counts(s, "guest_bucket", 4)}

    def discretize(s):
        b = fit_transform(s, M.QuantileDiscretizer(
            FEATURE_BUCKETS, "price_imp", "price_q"))
        return {"splits": list(b.splits),
                "counts": counts(s, "price_q", FEATURE_BUCKETS)}

    def expand(s):
        df = M.VectorAssembler(["guest", "price_imp", "tier_vec"],
                               "raw").transform(s["df"])
        s["df"] = M.PolynomialExpansion(2, "raw", "poly").transform(df)
        return {"width": int(s["df"]._column_values("poly").shape[1])}

    def scale(s):
        m = fit_transform(s, M.StandardScaler("poly", "scaled",
                                              with_mean=True, with_std=True))
        return {"mean": np.asarray(m.mean), "std": np.asarray(m.std)}

    def pca(s):
        m = fit_transform(s, M.PCA(FEATURE_PCA_K, "scaled", "pca"))
        return {"pc": np.asarray(m.pc),
                "explained_variance": np.asarray(m.explained_variance)}

    def correlation(s):
        return {m: np.asarray(M.Correlation.corr(s["df"], "scaled", m))
                for m in ("pearson", "spearman")}

    def summarize(s):
        out = M.Summarizer(M.Summarizer.METRICS).summary(s["df"], "scaled")
        return {k: np.asarray(v) for k, v in out.items()}

    def chi_square(s):
        df = M.VectorAssembler(["guest_bucket", "price_q"],
                               "buckets").transform(s["df"])
        res = M.ChiSquareTest.test(df, "buckets", "band").to_pydict()
        return {k: np.asarray(res[k][0], np.float64)
                for k in ("pValues", "degreesOfFreedom", "statistics")}

    def univariate(s):
        m = M.UnivariateFeatureSelector(
            selection_mode="numTopFeatures",
            selection_threshold=FEATURE_TOP, features_col="scaled",
            label_col="band", output_col="top").fit(s["df"])
        s["df"] = m.transform(s["df"])
        return {"selected": list(m.selected_features)}

    def variance(s):
        m = M.VarianceThresholdSelector(FEATURE_VARIANCE, "scaled",
                                        "kept").fit(s["df"])
        s["df"] = m.transform(s["df"])
        return {"selected": list(m.selected_features)}

    def logistic(s):
        m = M.LogisticRegression(max_iter=50, reg_param=FEATURE_REG,
                                 features_col="pca", label_col="l2").fit(
                                     s["df"])
        return _lr_numbers(m)

    def formula(s):
        pipe = M.Pipeline([
            M.Imputer(["price_holed"], ["price_imp"], strategy="median"),
            M.SQLTransformer(FEATURE_DERIVED),
            M.RFormula(FEATURE_FORMULA),
            M.PolynomialExpansion(2, "features", "poly"),
            M.StandardScaler("poly", "scaled", with_mean=True,
                             with_std=True),
            M.PCA(FEATURE_PCA_K, "scaled", "pca"),
            M.LogisticRegression(max_iter=50, reg_param=FEATURE_REG,
                                 features_col="pca", label_col="label")])
        model = pipe.fit(s["base"])
        path = os.path.join(tmp, "feature_pipeline")
        model.write().overwrite().save(path)
        loaded = M.PipelineModel.load(path)
        a = _valid_host(model.transform(s["base"]), "prediction")
        b = _valid_host(loaded.transform(s["base"]), "prediction")
        rf = model.stages[2]
        return {**_lr_numbers(model.stages[-1]),
                "encoders": [[list(e) for e in t] for t in rf.encoders],
                "positives": int(a.sum()),
                "loaded_same": bool(a.tobytes() == b.tobytes())}

    return (("string_indexer", index), ("one_hot", onehot),
            ("imputer", impute), ("bucketizer", bucketize),
            ("quantile_discretizer", discretize),
            ("polynomial_expansion", expand), ("standard_scaler", scale),
            ("pca", pca), ("correlation", correlation),
            ("summarizer", summarize), ("chi_square", chi_square),
            ("univariate_selector", univariate),
            ("variance_selector", variance), ("logistic", logistic),
            ("rformula_pipeline", formula))


def run_features(M, df, tmp: str, counted: bool = False):
    """Every step of ``feature_steps`` once on the clean table ``df``;
    returns (results, per-step host-clock ms to a device synchronisation,
    per-step launch counts when ``counted``)."""
    state = {"df": df, "base": df}
    res, ms, launches = {}, {}, {}
    for name, fn in feature_steps(M, tmp):
        out, counts, s = driven(fn, state)
        res[name], ms[name] = out, 1e3 * s
        if counted:
            launches[name] = counts
    return res, ms, launches


def _abs(got, want) -> float:
    """The largest |got - want| (0 where both are NaN)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    both_nan = np.isnan(got) & np.isnan(want)
    return float(np.max(np.where(both_nan, 0.0, np.abs(got - want)),
                        initial=0.0))


def check_features(card: dict, ref: dict) -> dict:
    """Phase 15's gates, card (float32) against the float64 run of the
    same steps on the same rows; raises listing every gate missed, and
    returns each float output's largest error and the PCA eigen-gaps."""
    bad, errs = [], {}
    for step, key in (("string_indexer", "labels"), ("one_hot", "sizes"),
                      ("imputer", "surrogates"), ("bucketizer", "counts"),
                      ("quantile_discretizer", "splits"),
                      ("quantile_discretizer", "counts"),
                      ("polynomial_expansion", "width"),
                      ("univariate_selector", "selected"),
                      ("variance_selector", "selected"),
                      ("chi_square", "degreesOfFreedom"),
                      ("rformula_pipeline", "encoders"),
                      ("rformula_pipeline", "loaded_same")):
        got, want = card[step][key], ref[step][key]
        if not same_canon(got, want, dtypes=False):
            bad.append(f"{step}.{key} {got} vs {want}")
    if not card["rformula_pipeline"]["loaded_same"]:
        bad.append("the loaded PipelineModel predicts otherwise")

    def rel(step, key, tol=FEATURE_RTOL):
        errs[f"{step}.{key}"] = e = rel_err(card[step][key], ref[step][key])
        if not e <= tol:
            bad.append(f"{step}.{key} relative error {e}")

    def absolute(step, key, tol=FEATURE_ATOL):
        errs[f"{step}.{key}"] = e = _abs(card[step][key], ref[step][key])
        if not e <= tol:
            bad.append(f"{step}.{key} error {e}")

    rel("standard_scaler", "std")
    absolute("standard_scaler", "mean", FEATURE_RTOL * float(np.max(
        np.abs(ref["standard_scaler"]["mean"]))))
    rel("pca", "explained_variance")
    for m in ("pearson", "spearman"):
        # a constant column has no correlation (NaN) in float64; in
        # float32 its ranks' rounded mean leaves a spread: not held
        want = np.asarray(ref["correlation"][m])
        errs[f"correlation.{m}.constant_entries"] = int(np.isnan(want).sum())
        errs[f"correlation.{m}"] = e = _abs(
            np.where(np.isnan(want), 0.0, card["correlation"][m]),
            np.nan_to_num(want))
        if not e <= FEATURE_ATOL:
            bad.append(f"correlation.{m} error {e}")
    for k in ("variance", "std", "normL1", "normL2", "min", "max"):
        rel("summarizer", k)
    absolute("summarizer", "mean")
    rel("summarizer", "numNonZeros", FEATURE_NNZ_RTOL)
    if card["summarizer"]["count"] != ref["summarizer"]["count"]:
        bad.append("summarizer.count")
    rel("chi_square", "statistics")
    absolute("chi_square", "pValues", 1e-6)
    # PCA: components whose float64 eigen-gap is clear of their neighbours
    vals = np.sort(np.asarray(ref["pca"]["explained_variance"]))[::-1]
    gaps = np.abs(np.diff(vals)) / max(vals[0], 1e-300)
    gap = np.minimum(np.r_[np.inf, gaps], np.r_[gaps, np.inf])
    held = [j for j in range(FEATURE_PCA_K) if gap[j] > FEATURE_PCA_GAP]
    errs["pca.pc"] = e = _abs(card["pca"]["pc"][:, held],
                              ref["pca"]["pc"][:, held])
    errs["pca.gaps"] = gap.tolist()
    errs["pca.held"] = held
    if not e <= FEATURE_PCA_ATOL:
        bad.append(f"pca.pc error {e} on components {held}")
    for step in ("logistic", "rformula_pipeline"):
        got, want = card[step], ref[step]
        # the coefficients of the PCA components, as one block
        errs[f"{step}.coef"] = e = max(
            rel_err(got[k], want[k], block=True)
            for k in ("coef", "intercept"))
        if e > CLASSIFIER_RTOL:
            bad.append(f"{step} coefficients {got['coef']} vs "
                       f"{want['coef']}")
        if abs(got["iterations"] - want["iterations"]) > ITERATION_SLACK:
            bad.append(f"{step} iterations {got['iterations']} vs "
                       f"{want['iterations']}")
        errs[f"{step}.objective"] = e = abs(
            got["objective"] - want["objective"]) / abs(want["objective"])
        if e > OBJECTIVE_RTOL:
            bad.append(f"{step} objective {got['objective']} vs "
                       f"{want['objective']}")
    if bad:
        raise AssertionError(f"phase 15 gates: {'; '.join(bad)} "
                             f"(errors {errs})")
    return errs


# The host steps of phase 15, as in the JAX package: the StringIndexer's
# order of its distinct labels (string_indexer, rformula_pipeline), the
# selectors' and the chi-square test's scipy tails (univariate_selector,
# chi_square) and the words' lookup of each string column's dictionary.
FEATURE_HOST_STEPS = {
    "string_indexer": "labels ordered by (count, label)",
    "chi_square": "chi2.sf of each feature's table",
    "univariate_selector": "f.sf of the ANOVA F statistics",
    "rformula_pipeline": "the tier's labels ordered; its words looked up",
}


def feature_tables(device: str, cols: dict, keep=None):
    """A session and phase 15's clean table on ``device``: on the card
    through one dq_rules launch (``clean_table``), for the reference with
    the card's clean rows (``keep``) as its mask."""
    import torch

    if keep is None:
        spark, clean = clean_table(device, cols["guest"], cols["price"])
    else:
        spark = session(device)
        clean = spark.createDataFrame({"guest": cols["guest"],
                                       "price": cols["price"]}).filter(
            torch.as_tensor(keep, device=device))
    clean = clean.with_column("price_holed", cols["price_holed"]) \
        .with_column("tier", cols["tier"])
    return spark, feature_frame(clean)


def feature_numpy(cols: dict, keep: np.ndarray) -> dict:
    """Phase 15's exact results over every clean row from numpy alone: the
    tier labels by (count, label), the Imputer's median, the guest bucket
    counts, the price splits and their bucket counts (the card's
    Bucketizer compares float32 values with float32 splits), the valid
    row count, and each chi-square table's statistic and degrees of
    freedom against the band."""
    p32 = cols["price"][keep].astype(np.float32)
    band = (p32 >= BAND_PRICES[0]).astype(np.int64) + (p32 >= BAND_PRICES[1])
    per_tier = np.bincount(band, minlength=3)
    labels = sorted((t for t, c in zip(FEATURE_TIERS, per_tier) if c),
                    key=lambda t: (-per_tier[FEATURE_TIERS.index(t)], t))
    holed = cols["price_holed"][keep]
    surrogate = float(np.median(holed[~np.isnan(holed)]))
    imp = np.where(np.isnan(holed), np.float32(surrogate),
                   holed.astype(np.float32))
    inner = np.unique(np.quantile(imp.astype(np.float64), np.linspace(
        0, 1, FEATURE_BUCKETS + 1)[1:-1]))
    splits = [-float("inf"), *inner.tolist(), float("inf")]

    def buckets(x, edges):
        e = np.asarray(edges, np.float32)
        return np.clip(np.searchsorted(e, x, side="right") - 1, 0,
                       len(e) - 2)

    g = buckets(cols["guest"][keep].astype(np.float32),
                FEATURE_GUEST_SPLITS)
    q = buckets(imp, splits)
    tables = {}
    for name, ids, k in (("guest_bucket", g, 4),
                         ("price_q", q, len(splits) - 1)):
        t = np.bincount(ids * 3 + band, minlength=k * 3).reshape(k, 3)
        t = t[t.sum(1) > 0][:, t.sum(0) > 0].astype(np.float64)
        expected = t.sum(1, keepdims=True) @ t.sum(0, keepdims=True) / t.sum()
        tables[name] = (float(((t - expected) ** 2 / expected).sum()),
                        (t.shape[0] - 1) * (t.shape[1] - 1))
    return {"labels": labels, "surrogates": [surrogate],
            "guest_counts": np.bincount(g, minlength=4),
            "splits": splits,
            "price_counts": np.bincount(q, minlength=len(splits) - 1),
            "count": int(keep.sum()),
            "chi_statistics": [tables[k][0] for k in tables],
            "chi_dof": [tables[k][1] for k in tables]}


def check_features_numpy(card: dict, want: dict) -> dict:
    """The card's full-size run against ``feature_numpy``: exact but for
    the chi-square statistics, within FEATURE_RTOL (the card's tables are
    exact counts; its statistic is computed in float32)."""
    got = {"labels": card["string_indexer"]["labels"],
           "surrogates": card["imputer"]["surrogates"],
           "guest_counts": card["bucketizer"]["counts"],
           "splits": card["quantile_discretizer"]["splits"],
           "price_counts": card["quantile_discretizer"]["counts"],
           "count": card["summarizer"]["count"],
           "chi_dof": [int(v) for v in
                       card["chi_square"]["degreesOfFreedom"]]}
    bad = [k for k in got if not same_canon(got[k], want[k], dtypes=False)]
    err = rel_err(card["chi_square"]["statistics"],
                  want["chi_statistics"])
    if bad or not err <= FEATURE_RTOL:
        raise AssertionError(
            f"phase 15 against numpy: {bad} differ, chi-square statistics "
            f"within {err}: card {got}, numpy {want}")
    return {"chi_statistics": err}


def check_features_full(rows: int = FULL_ROWS) -> dict:
    """Phase 15: the feature pipeline on the 10^7-row table cleaned by one
    dq_rules launch, twice on the card in float32 (the first run with its
    launch counts by step, the second under torch.profiler for the idle
    share; bit-identical) and its exact results against numpy over every
    clean row; then the same steps on the first HEAD_ROWS clean rows, on
    the card in float32 and on the CPU in float64, and the gates between
    those two runs. (The CPU float64 run of every step at 9.6 M rows takes
    about 80 s on the card's machine's 8 cores, past the phase's budget:
    the Spearman ranks alone sort 28 columns of 9.6 M values.)"""
    import tempfile

    import torch

    from sparkdq4ml_tpu_torch import models as M
    from sparkdq4ml_tpu_torch.config import float_policy
    from sparkdq4ml_tpu_torch.ops import kernels
    from sparkdq4ml_tpu_torch.sql import default_catalog

    import scipy.stats  # noqa: F401  (its first import, outside the steps)

    t0 = time.perf_counter()
    cols = feature_columns(*full_table(rows))
    data_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        kernels.launches.reset()
        spark, clean = feature_tables("cuda", cols)
        torch.cuda.synchronize()
        clean_counts = kernels.launches.snapshot()
        if clean_counts["dq_rules"] != 1:
            raise AssertionError(f"phase 15's clean table: {clean_counts}")
        t_card = time.perf_counter()
        card, ms, launches = run_features(M, clean, tmp, counted=True)
        again = {}
        profile = profile_run("features", lambda: again.update(
            run_features(M, clean, tmp)[0]))
        card_s = time.perf_counter() - t_card
        differ = [k for k in card if not same_canon(card[k], again[k])]
        if differ:
            raise AssertionError(f"phase 15 differs between two card runs: "
                                 f"{differ}")
        keep = clean._host_mask()
        t0 = time.perf_counter()
        numpy_errs = check_features_numpy(card, feature_numpy(cols, keep))
        numpy_s = time.perf_counter() - t0
        head = head_of(clean)
        end = head.num_slots
        head_card = run_features(M, head, tmp)[0]
        del head, clean
        spark.stop()
        default_catalog().clear()
        t0 = time.perf_counter()
        with float_policy(torch.float64):
            spark, ref_head = feature_tables(
                "cpu", {k: v[:end] for k, v in cols.items()}, keep[:end])
            ref, ref_ms, _ = run_features(M, ref_head, tmp)
            spark.stop()
        default_catalog().clear()
        ref_s = time.perf_counter() - t0
    errs = check_features(head_card, ref)
    totals = {k: sum(c[k] for c in launches.values())
              for k in kernels.KERNELS}
    missing = [k for k in FEATURE_KERNELS
               if k != "dq_rules" and totals[k] == 0]
    if missing:
        raise AssertionError(f"phase 15 launched no {missing}: {launches}")
    summary = {"labels": card["string_indexer"]["labels"],
               "surrogate": card["imputer"]["surrogates"],
               "splits": card["quantile_discretizer"]["splits"],
               "selected": {k: card[k]["selected"] for k in (
                   "univariate_selector", "variance_selector")},
               "logistic": card["logistic"],
               "rformula": {k: card["rformula_pipeline"][k] for k in (
                   "iterations", "objective", "positives")}}
    log(f"phase 15 at {rows} rows ({int(keep.sum())} clean): "
        f"{json.dumps(summary, default=str)}; step ms {ms}; launches "
        f"{totals} (clean table {clean_counts}); against numpy "
        f"{numpy_errs}; head errors {json.dumps(errs, default=str)}; idle "
        f"share {profile['device_idle_share']}; float64 reference "
        f"{ref_s:.1f} s; host steps {FEATURE_HOST_STEPS}")
    return {"rows": rows, "clean_rows": int(keep.sum()), "summary": summary,
            "step_ms": ms, "launches": launches, "launch_totals": totals,
            "clean_launches": clean_counts, "numpy_errors": numpy_errs,
            "head_errors": errs, "head_rows": HEAD_ROWS,
            "profile": profile, "reference_step_ms": ref_ms,
            "host_steps": FEATURE_HOST_STEPS,
            "host_step_count": len(FEATURE_HOST_STEPS), "data_s": data_s,
            "card_s": card_s, "numpy_s": numpy_s,
            "cpu_float64_reference_s": ref_s}


# ---------------------------------------------------------------------------
# Phase 16: a text-classification pass and a MovieLens-20M-shaped recommender
# ---------------------------------------------------------------------------

TEXT_DOCS = 100_000
TEXT_WORDS = 20_000             # content words: TEXT_TOPICS topics of 5,000
TEXT_TOPICS = 4
TEXT_STOP_SHARE = 0.3
TEXT_FEATURES = 1024
TEXT_VOCAB = 4096
TEXT_MIN_DF = 5
TEXT_LAYERS = (1024, 64, 32, 4)
TEXT_STEPS = 100
TEXT_STEP_SIZE = 0.03
TEXT_SEED = 17
TEXT_IDF_RTOL = 1e-6
TEXT_LOSS_RTOL = 1e-4           # the MLP on the TF-IDF, against float64
TEXT_UNIT_LOSS_RTOL = 1e-4      # the extra case: on unit rows
TEXT_ACCURACY_TOL = 1e-3
# the corpus's stop words, all in the default English list ("a" and "i"
# fall to RegexTokenizer's minTokenLength 2 before the remover sees them)
TEXT_STOP = ("the", "of", "and", "a", "to", "in", "is", "it", "that", "for",
             "was", "on", "with", "as", "i", "at", "by", "this", "from",
             "or")
TEXT_SYLLABLES = ("ka", "lo", "mi", "ne", "ru", "sa", "ti", "vo", "ze", "da",
                  "fe", "go", "hu", "ji", "pa", "qu", "re", "so", "tu", "wy")
# GroupLens' MovieLens 20M (ml-20m/README.txt): 20,000,263 ratings by
# 138,493 users of 26,744 movies, 0.5-5 stars in half steps, every user at
# least 20 ratings; the most rated movie has 67,310 and the most active
# user 9,254.
ML20M_RATINGS = 20_000_263
ML20M_USERS = 138_493
ML20M_MOVIES = 26_744
ML20M_MOVIE_IDS = 131_262       # movie ids run from 1 to 131,262
ML20M_MIN_PER_USER = 20
ML20M_MAX_PER_USER = 9_254
ML20M_TOP_MOVIE = 67_310
REC_RANK = 10                   # Spark's ALS defaults: rank 10, maxIter 10,
REC_ITERS = 10                  # regParam 0.1
REC_REG = 0.1
REC_ALPHA = 1.0
REC_SEED = 23
REC_NOISE = 0.8                 # the planted ratings' noise (stars)
REC_SIGNAL = 0.8                # the planted taste's spread (stars)
REC_MEAN = 3.5
REC_HELD_OUT = 100_000
REC_TOP = 10
REC_RTOL = 1e-4                 # losses and training RMSE against float64
REC_PREDICT_ATOL = 1e-3         # held-out predictions against float64
REC_GAP = 1e-4                  # a top-10 place is held where float64's
#                                 scores around it are this far apart
REC_NOISE_SHARE = 0.1           # training RMSE within 10% of the noise


def text_words() -> list:
    """TEXT_WORDS content words: word j is its base-20 digits as
    syllables, three of them (six letters) below 8,000, four above, so no
    content word is a stop word or shorter than RegexTokenizer's minimum."""
    out = []
    for j in range(TEXT_WORDS):
        digits = 3 if j < 20 ** 3 else 4
        out.append("".join(TEXT_SYLLABLES[(j // 20 ** p) % 20]
                           for p in reversed(range(digits))))
    return out


def text_corpus(docs: int = TEXT_DOCS, seed: int = TEXT_SEED) -> dict:
    """Seeded raw documents of 20-100 words: about TEXT_STOP_SHARE of the
    words are stop words, the content words drawn by Zipf rank from the
    5,000 of the document's topic (its label; word
    ``rank * TEXT_TOPICS + topic``); a document's first word and a word
    after a period are capitalized, about 8% of the words carry a comma and
    6% a period. The generating ids and forms come back with the text for
    the reference."""
    rng = np.random.default_rng(seed)
    per = TEXT_WORDS // TEXT_TOPICS
    lens = rng.integers(20, 101, docs)
    topic = rng.integers(0, TEXT_TOPICS, docs)
    n = int(lens.sum())
    stop = rng.random(n) < TEXT_STOP_SHARE
    ranks = rng.choice(per, size=n, p=_zipf(per))
    content = ranks * TEXT_TOPICS + np.repeat(topic, lens)
    ids = np.where(stop, TEXT_WORDS + rng.integers(0, len(TEXT_STOP), n),
                   content)
    u = rng.random(n)
    punct = np.where(u < 0.06, 2, np.where(u < 0.14, 1, 0))    # ".", ","
    start = np.zeros(n, bool)
    start[np.cumsum(lens) - lens] = True
    cap = start.copy()
    cap[1:] |= punct[:-1] == 2
    vocab = text_words() + list(TEXT_STOP)
    table = np.empty((len(vocab), 6), dtype=object)
    for c in (0, 1):
        for p, suffix in enumerate(("", ",", ".")):
            table[:, 3 * c + p] = [(w.capitalize() if c else w) + suffix
                                   for w in vocab]
    surface = table[ids, 3 * cap + punct].tolist()
    ends = np.cumsum(lens)
    text = np.empty(docs, dtype=object)
    text[:] = [" ".join(surface[e - k:e]) for e, k in zip(ends.tolist(),
                                                        lens.tolist())]
    return {"text": text, "label": topic.astype(np.float64), "ids": ids,
            "lens": lens, "form": 3 * cap + punct, "table": table,
            "vocab": vocab}


def _md5_bucket(word: str, mod: int) -> int:
    import hashlib

    return int.from_bytes(hashlib.md5(word.encode()).digest()[:8],
                          "little") % mod


def _sparse(flat_index: np.ndarray) -> tuple:
    """(sorted distinct flat indices, how often each occurs)."""
    return np.unique(flat_index, return_counts=True)


def text_reference(corpus: dict) -> dict:
    """Each stage's expected output from the corpus's generating ids, in
    numpy and Python written here: a token column as (its tokens in
    order, tokens a document) for the Tokenizer (each surface form
    lowercased), RegexTokenizer (the words of at least two letters), the
    stop-word-free words and the bigrams; HashingTF's counts (the md5
    bucket of each word) and CountVectorizer's over the bigrams as (sorted
    flat indices, counts); the vocabulary in its order; the IDF weights in
    float64."""
    ids, lens, vocab = corpus["ids"], corpus["lens"], corpus["vocab"]
    low = np.vectorize(str.lower, otypes=[object])(corpus["table"])
    docs = len(lens)
    doc_of = np.repeat(np.arange(docs), lens)
    vocab_arr = np.asarray(vocab, dtype=object)
    out = {"words": (low[ids, corpus["form"]].tolist(), lens)}
    long = np.asarray([len(w) >= 2 for w in vocab])[ids]
    out["tokens"] = (vocab_arr[ids[long]].tolist(),
                     np.bincount(doc_of[long], minlength=docs))
    keep = ids < TEXT_WORDS
    cid, cdoc = ids[keep], doc_of[keep]
    out["clean"] = (vocab_arr[cid].tolist(),
                    np.bincount(cdoc, minlength=docs))
    # bigrams: consecutive clean words of one document
    same = cdoc[1:] == cdoc[:-1]
    first, second, bdoc = cid[:-1][same], cid[1:][same], cdoc[:-1][same]
    spaced = np.asarray([w + " " for w in vocab], dtype=object)
    out["bigrams"] = ((spaced[first] + vocab_arr[second]).tolist(),
                      np.bincount(bdoc, minlength=docs))
    bucket = np.asarray([_md5_bucket(w, TEXT_FEATURES)
                         for w in vocab[:TEXT_WORDS]])
    out["tf"] = _sparse(cdoc * TEXT_FEATURES + bucket[cid])
    code = first.astype(np.int64) * TEXT_WORDS + second
    pairs = np.unique(bdoc.astype(np.int64) * TEXT_WORDS ** 2 + code)
    codes, df = np.unique(pairs % TEXT_WORDS ** 2, return_counts=True)
    kept = df >= TEXT_MIN_DF
    ranked = sorted((-int(n), f"{vocab[k // TEXT_WORDS]} "
                              f"{vocab[k % TEXT_WORDS]}", int(k))
                    for n, k in zip(df[kept], codes[kept]))[:TEXT_VOCAB]
    out["vocabulary"] = [w for _, w, _ in ranked]
    vcode = np.asarray([k for _, _, k in ranked], np.int64)
    order = np.argsort(vcode)
    at = np.minimum(np.searchsorted(vcode[order], code), max(len(vcode) - 1,
                                                             0))
    hit = vcode[order][at] == code if len(vcode) else np.zeros_like(same)
    out["cv"] = _sparse(bdoc[hit] * len(ranked) + order[at[hit]])
    dfb = np.bincount(out["tf"][0] % TEXT_FEATURES, minlength=TEXT_FEATURES)
    out["idf"] = np.log((docs + 1.0) / (dfb + 1.0))
    return out


def _card_sparse(M) -> tuple:
    """(flat indices, values) of the nonzero entries of a card matrix, on
    the host."""
    import torch

    flat = M.reshape(-1)
    at = torch.nonzero(flat).reshape(-1)
    return at.cpu().numpy(), flat[at].cpu().numpy()


def text_steps(M, frame, times: dict) -> tuple:
    """The text stages on ``frame`` (its ``text`` and ``label``), each
    timed to a device synchronization: Tokenizer, RegexTokenizer (\\W+,
    minTokenLength 2), StopWordsRemover, NGram(2), HashingTF(1024) on the
    words, CountVectorizer (vocabSize 4096, minDF 5) on the bigrams, IDF on
    the term frequencies into ``tfidf`` (what the MLP fits), and for the
    extra case Normalizer (p = 2) of the TF-IDF into ``unit``. Returns (the
    frame, the fitted models)."""
    import torch

    sync = (torch.cuda.synchronize if frame.device.type == "cuda"
            else lambda: None)
    stages = [("tokenizer", M.Tokenizer("text", "words")),
              ("regex_tokenizer", M.RegexTokenizer(
                  "text", "tokens", pattern=r"\W+", min_token_length=2)),
              ("stop_words", M.StopWordsRemover("tokens", "clean")),
              ("ngram", M.NGram(2, "clean", "bigrams")),
              ("hashing_tf", M.HashingTF(TEXT_FEATURES, "clean", "tf")),
              ("count_vectorizer", M.CountVectorizer(
                  vocab_size=TEXT_VOCAB, min_df=float(TEXT_MIN_DF),
                  input_col="bigrams", output_col="cv")),
              ("idf", M.IDF(input_col="tf", output_col="tfidf")),
              ("normalizer", M.Normalizer("tfidf", "unit", p=2.0))]
    models = {}
    for name, stage in stages:
        sync()
        t0 = time.perf_counter()
        if hasattr(stage, "fit"):
            stage = stage.fit(frame)
            models[name] = stage
        frame = stage.transform(frame)
        sync()
        times[name] = 1e3 * (time.perf_counter() - t0)
    return frame, models


def check_text(frame, models, want: dict) -> dict:
    """Phase 16(a)'s exact gates and the IDF weights against float64."""
    from itertools import chain

    bad = []
    for name in ("words", "tokens", "clean", "bigrams"):
        col = frame._column_values(name)
        lens = np.fromiter(map(len, col), np.int64, count=len(col))
        if not (np.array_equal(lens, want[name][1])
                and list(chain.from_iterable(col)) == want[name][0]):
            bad.append(name)
    if bad:
        raise AssertionError(f"phase 16: token columns differ from the "
                             f"reference: {bad}")
    if models["count_vectorizer"].vocabulary != want["vocabulary"]:
        raise AssertionError("phase 16: the CountVectorizer vocabulary or "
                             "its order differs from the reference")
    for name in ("tf", "cv"):
        at, val = _card_sparse(frame._column_values(name))
        if not (np.array_equal(at, want[name][0])
                and np.array_equal(val, want[name][1])):
            raise AssertionError(f"phase 16: {name} counts differ from the "
                                 "reference")
    idf = np.asarray(models["idf"].idf, np.float64)
    err = np.abs(idf - want["idf"])
    idf_err = float(np.max(err / want["idf"]))
    if idf_err > TEXT_IDF_RTOL:
        raise AssertionError(f"phase 16: IDF off by {idf_err} relative")
    return {"idf_max_rel_err": idf_err,
            "idf_max_abs_err": float(np.max(err)),
            "idf_min": float(np.min(want["idf"])),
            "vocabulary_size": len(want["vocabulary"]),
            "tf_nonzeros": int(want["tf"][0].size),
            "cv_nonzeros": int(want["cv"][0].size),
            "tokens": len(want["tokens"][0])}


def mlp_fit_on(M, frame, features: str = "tfidf"):
    """One MultilayerPerceptronClassifier fit on the ``features`` column
    (the TF-IDF, or its unit rows) and its training accuracy."""
    model = M.MultilayerPerceptronClassifier(
        layers=list(TEXT_LAYERS), max_iter=TEXT_STEPS,
        step_size=TEXT_STEP_SIZE, seed=TEXT_SEED, features_col=features,
        label_col="label").fit(frame)
    pred = model.transform(frame)._column_values("prediction")
    label = frame._column_values("label")
    return {"model": model,
            "accuracy": float((pred == label.to(pred.dtype)).double()
                              .mean()),
            "loss": np.asarray(model.loss_history)}


def mlp_float64_reference(frame, tf64, idf64, unit: bool) -> dict:
    """The MLP fit in float64 on the card from the float32 run's initial
    weights (its Glorot draws, widened), on the float64 TF-IDF (``unit``:
    scaled to unit rows)."""
    import torch

    from sparkdq4ml_tpu_torch.models import mlp

    X = tf64 * torch.as_tensor(idf64, device=tf64.device)
    if unit:
        norm = torch.sqrt((X * X).sum(dim=1, keepdim=True))
        X = torch.where(norm > 0, X / torch.where(norm > 0, norm, 1.0), X)
    y = frame._column_values("label").to(torch.float64)
    mask = frame.mask
    start = [(W.double(), b.double()) for W, b in mlp.glorot_params(
        TEXT_LAYERS, TEXT_SEED, torch.float32, tf64.device)]
    params, hist = mlp.mlp_fit(X, y, mask, list(TEXT_LAYERS), TEXT_STEPS,
                               TEXT_STEP_SIZE, TEXT_SEED, params0=start)
    pred = torch.argmax(mlp._mlp_forward(params, X), dim=1)
    return {"loss": hist.cpu().numpy(),
            "accuracy": float((pred == y.to(torch.int64)).double().mean())}


def check_text_full(docs: int = TEXT_DOCS, device: str = "cuda") -> dict:
    """Phase 16(a): the text stages on the card on ``docs`` seeded raw
    documents against the numpy reference (exact; the IDF weights within
    TEXT_IDF_RTOL relative), then the MLP on the TF-IDF
    twice (bit-identical) with its launch counts, against its float64 run
    on the card from the same draws; and, as an extra case, the MLP once on
    the TF-IDF's unit rows against its own float64 run."""
    import torch

    from sparkdq4ml_tpu_torch import models as M
    from sparkdq4ml_tpu_torch.config import float_policy
    from sparkdq4ml_tpu_torch.frame.frame import Frame

    t0 = time.perf_counter()
    corpus = text_corpus(docs)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = text_reference(corpus)
    ref_s = time.perf_counter() - t0
    raw = Frame({"text": corpus["text"], "label": corpus["label"]},
                device=device)
    step_ms = {}
    (frame, models), text_launches, text_s = driven(
        text_steps, M, raw, step_ms)
    t0 = time.perf_counter()
    gates = check_text(frame, models, want)
    check_s = time.perf_counter() - t0
    card, launches, fit_ms = [], {}, []
    for _ in range(2):
        res, launches, s = driven(mlp_fit_on, M, frame)
        card.append(res)
        fit_ms.append(1e3 * s)
    a, b = (r["model"] for r in card)
    same = (a.loss_history == b.loss_history and all(
        np.array_equal(x, y) for (x, _), (y, _) in zip(a.weights, b.weights))
        and all(np.array_equal(x, y) for (_, x), (_, y) in zip(a.weights,
                                                                b.weights)))
    if not same:
        raise AssertionError("phase 16: the MLP fit differs between two "
                             "card runs")
    t0 = time.perf_counter()
    unit = mlp_fit_on(M, frame, "unit")
    unit_fit_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    with float_policy(torch.float64):
        tf64 = frame._column_values("tf").to(torch.float64)
        idf64 = M.IDF(input_col="tf", output_col="o").fit(
            frame.with_column("tf", tf64)).idf
        ref = mlp_float64_reference(frame, tf64, idf64, unit=False)
        ref_unit = mlp_float64_reference(frame, tf64, idf64, unit=True)
        del tf64
    ref64_s = time.perf_counter() - t0
    mlp = {}
    for name, got, want64, rtol in (
            ("tfidf", card[0], ref, TEXT_LOSS_RTOL),
            ("unit_rows", unit, ref_unit, TEXT_UNIT_LOSS_RTOL)):
        loss_err = float(np.max(np.abs(got["loss"] - want64["loss"])
                                / np.abs(want64["loss"])))
        acc_err = abs(got["accuracy"] - want64["accuracy"])
        mlp[name] = {"accuracy": got["accuracy"],
                     "float64_accuracy": want64["accuracy"],
                     "loss_first_last": [float(got["loss"][0]),
                                         float(got["loss"][-1])],
                     "loss_max_rel_err": loss_err, "loss_rtol": rtol,
                     "accuracy_err": acc_err}
        if loss_err > rtol or acc_err > TEXT_ACCURACY_TOL:
            raise AssertionError(f"phase 16: the MLP on {name} against "
                                 f"float64: loss off by {loss_err}, "
                                 f"accuracy by {acc_err}")
    out = {"docs": docs, "gates": gates, "step_ms": step_ms,
           "text_ms": 1e3 * text_s, "text_launches": text_launches,
           "mlp_fit_ms": fit_ms, "mlp_launches": launches,
           "mlp_unit_rows_fit_ms": unit_fit_ms, "mlp": mlp,
           "data_s": data_s, "numpy_reference_s": ref_s,
           "check_s": check_s,
           "float64_reference_s": ref64_s}
    log(f"phase 16(a) text at {docs} documents: {json.dumps(out)}")
    return out


def _zipf_exponent(m: int, top_share: float) -> float:
    """The exponent s of a Zipf law over ``m`` ranks whose first rank
    holds ``top_share`` of the mass (bisection)."""
    ranks = np.arange(1, m + 1, dtype=np.float64)
    lo, hi = 0.0, 2.0
    for _ in range(60):
        s = 0.5 * (lo + hi)
        share = 1.0 / np.sum(ranks ** -s)
        lo, hi = (s, hi) if share < top_share else (lo, s)
    return 0.5 * (lo + hi)


def rec_data(users: int = ML20M_USERS, movies: int = ML20M_MOVIES,
             ratings: int = ML20M_RATINGS, held_out: int = REC_HELD_OUT,
             device: str = "cuda", seed: int = REC_SEED) -> dict:
    """Seeded ratings of MovieLens 20M's shape: ``ratings`` training
    ratings by ``users`` users (each at least ML20M_MIN_PER_USER and at
    most ML20M_MAX_PER_USER, the extra counts log-normal), of ``movies``
    movies with Zipf popularity (the most rated holding ML-20M's share),
    every (user, movie) pair once, and ``held_out`` more ratings spread
    over the users as the training ones are. A rating is a planted rank-10
    taste (REC_MEAN on a constant factor and nine factors spreading
    REC_SIGNAL stars) plus N(0, REC_NOISE²), rounded to half stars and
    clipped to 0.5-5. The pairs and ratings are drawn on ``device``."""
    import torch

    rng = np.random.default_rng(seed)
    cap = min(ML20M_MAX_PER_USER, int(0.35 * movies))
    extra = rng.lognormal(0.0, 1.2, users)
    extra *= (ratings - ML20M_MIN_PER_USER * users) / extra.sum()
    counts = np.minimum(ML20M_MIN_PER_USER + np.floor(extra).astype(np.int64),
                        cap)
    short = ratings - int(counts.sum())
    while short:
        room = np.flatnonzero(counts < cap) if short > 0 else \
            np.flatnonzero(counts > ML20M_MIN_PER_USER)
        pick = rng.choice(room, min(abs(short), room.size), replace=False)
        counts[pick] += int(np.sign(short))
        short = ratings - int(counts.sum())
    held = rng.multinomial(held_out, counts / counts.sum())
    total = counts + held
    s = _zipf_exponent(movies, ML20M_TOP_MOVIE / ML20M_RATINGS)
    popularity = np.arange(1, movies + 1, dtype=np.float64) ** -s
    cdf = np.cumsum(popularity / popularity.sum())
    movie_ids = np.sort(rng.choice(
        np.arange(1, max(ML20M_MOVIE_IDS, movies) + 1), movies,
        replace=False))
    by_rank = rng.permutation(movies)           # a movie of each Zipf rank
    k = REC_RANK
    a = np.sqrt(REC_SIGNAL / np.sqrt(k - 1))
    U = np.concatenate([np.full((users, 1), np.sqrt(REC_MEAN)),
                        rng.normal(0.0, a, (users, k - 1))], axis=1)
    V = np.concatenate([np.full((movies, 1), np.sqrt(REC_MEAN)),
                        rng.normal(0.0, a, (movies, k - 1))], axis=1)
    gen = torch.Generator(device).manual_seed(seed)
    n = int(total.sum())
    user = torch.repeat_interleave(torch.arange(users, device=device),
                                   torch.as_tensor(total, device=device))
    cdf_d = torch.as_tensor(cdf, device=device)

    def draw(m):
        u = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        return torch.clamp(torch.searchsorted(cdf_d, u), max=movies - 1)

    rank = draw(n)
    for rounds in range(1, 200):
        key = user * movies + rank
        order = torch.sort(key, stable=True).indices
        ks = key.index_select(0, order)
        dup = torch.zeros(n, dtype=torch.bool, device=device)
        dup[1:] = ks[1:] == ks[:-1]
        again = order[dup]
        if again.numel() == 0:
            break
        rank[again] = draw(again.numel())
    else:
        raise AssertionError("rec_data: duplicate pairs remain")
    movie = torch.as_tensor(by_rank, device=device).index_select(0, rank)
    signal = torch.sum(torch.as_tensor(U, device=device).index_select(0, user)
                       * torch.as_tensor(V, device=device).index_select(
                           0, movie), dim=1)
    noisy = signal + REC_NOISE * torch.randn(n, generator=gen, device=device,
                                             dtype=torch.float64)
    stars = torch.clamp(torch.round(2.0 * noisy) / 2.0, 0.5, 5.0)
    # the last ``held`` ratings of each user are held out
    first = torch.as_tensor(np.cumsum(total) - total, device=device)
    within = torch.arange(n, device=device) - first.index_select(0, user)
    test = within >= torch.as_tensor(counts, device=device).index_select(
        0, user)
    train = ~test
    noise = float(torch.sqrt(torch.mean((stars[train] - signal[train]) ** 2)))
    ids = torch.as_tensor(movie_ids, device=device)

    def cols(pick):
        return {"userId": (user[pick] + 1).to(torch.int32),
                "movieId": ids.index_select(0, movie[pick]).to(torch.int32),
                "rating": stars[pick].to(torch.float32)}

    return {"train": cols(train), "test": cols(test), "noise_rms": noise,
            "zipf_s": s, "dedupe_rounds": rounds,
            "per_user": {"min": int(counts.min()), "max": int(counts.max()),
                         "median": float(np.median(counts))},
            "ratings": int(counts.sum()), "held_out": int(held.sum())}


def _rec_frame(cols: dict, device):
    from sparkdq4ml_tpu_torch.frame.frame import Frame

    return Frame(dict(cols), device=device)


def rec_estimator(M, implicit: bool):
    """Spark's defaults (rank 10, maxIter 10, regParam 0.1), the implicit
    form with alpha 1.0, on MovieLens' column names."""
    return M.ALS(rank=REC_RANK, max_iter=REC_ITERS, reg_param=REC_REG,
                 implicit_prefs=implicit, alpha=REC_ALPHA, seed=REC_SEED,
                 user_col="userId", item_col="movieId", rating_col="rating")


def rec_float64_reference(train: dict, implicit: bool):
    """The fit in float64 on the card from the float32 run's initial
    factors (``ALS.fit``'s numpy draws rounded to float32, widened), as an
    ``ALSModel`` under the float64 policy."""
    import torch

    from sparkdq4ml_tpu_torch import models as M
    from sparkdq4ml_tpu_torch.models import recommendation as R

    users = train["userId"].to(torch.int64)
    items = train["movieId"].to(torch.int64)
    u_ids, u_idx = torch.unique(users, sorted=True, return_inverse=True)
    i_ids, i_idx = torch.unique(items, sorted=True, return_inverse=True)
    rng = np.random.default_rng(REC_SEED)
    start = [torch.as_tensor((rng.normal(size=(len(ids), REC_RANK))
                              / np.sqrt(REC_RANK)).astype(np.float32)
                             .astype(np.float64), device=users.device)
             for ids in (u_ids, i_ids)]
    U, V, hist = R.als_fit(u_idx, i_idx, train["rating"].to(torch.float64),
                           start[0], start[1], len(u_ids), len(i_ids),
                           REC_RANK, REC_ITERS, REC_REG, implicit,
                           REC_ALPHA)
    return R.ALSModel(U.cpu().numpy(), V.cpu().numpy(), u_ids.cpu().tolist(),
                      i_ids.cpu().tolist(),
                      rec_estimator(M, implicit)._params_dict(),
                      hist.cpu().tolist(), device=users.device)


def _rmse(model, frame) -> float:
    import torch

    pred = model.transform(frame)._column_values("prediction")
    err = pred.to(torch.float64) - frame._column_values("rating").to(
        torch.float64)
    return float(torch.sqrt(torch.mean(err * err)))


def check_top(card_recs, ref, users: bool, what: str) -> dict:
    """Every place of every card top-10 (the recommendations column) equals
    the float64 model ``ref``'s where float64's scores around it (the next
    one included, from its top-11) are more than REC_GAP apart; the other
    places are counted."""
    got = np.asarray(card_recs.tolist(), np.float64)[:, :, 0].astype(
        np.int64)
    F = (ref.user_factors_arr, ref.item_factors_arr)
    vals, idx = ref._top_k(*(F if users else F[::-1]), REC_TOP + 1)
    scores = vals.cpu().numpy()
    want = np.asarray(ref.item_ids if users else ref.user_ids,
                      np.int64)[idx.cpu().numpy()]
    k = got.shape[1]
    gap = -np.diff(scores, axis=1)                       # (n, k)
    apart = np.ones_like(got, dtype=bool)
    apart[:, 1:] &= gap[:, :k - 1] > REC_GAP
    apart &= gap[:, :k] > REC_GAP
    wrong = apart & (got != want[:, :k])
    if wrong.any():
        rows = np.flatnonzero(wrong.any(axis=1))[:5]
        raise AssertionError(f"phase 16 {what}: top-{k} places differ from "
                             f"float64 where its scores are apart: rows "
                             f"{rows.tolist()}")
    return {"held_places": int(apart.sum()),
            "near_ties": int((~apart).sum()),
            "near_tie_places_differing": int((~apart & (got != want[:, :k]))
                                             .sum())}


def rec_run(M, train_f, implicit: bool) -> dict:
    """One fit and what it must give: factors, loss history, training
    RMSE."""
    model = rec_estimator(M, implicit).fit(train_f)
    return {"model": model, "loss": np.asarray(model.loss_history),
            "rmse": _rmse(model, train_f)}


def check_rec_full(users: int = ML20M_USERS, movies: int = ML20M_MOVIES,
                   ratings: int = ML20M_RATINGS,
                   held_out: int = REC_HELD_OUT, device: str = "cuda",
                   profile: bool = True) -> dict:
    """Phase 16(b): the explicit and the implicit fit on the card, each
    twice (bit-identical) with the launch counts set to 0 just before it
    and read just after; recommendForAllUsers(10) and
    recommendForAllItems(10) of the explicit model; one explicit fit under
    torch.profiler; against the float64 run of both fits on the card from
    the same initial factors."""
    import torch

    from sparkdq4ml_tpu_torch import models as M
    from sparkdq4ml_tpu_torch.config import float_policy

    t0 = time.perf_counter()
    data = rec_data(users, movies, ratings, held_out, device)
    train_f = _rec_frame(data["train"], device)
    test_f = _rec_frame(data["test"], device)
    data_s = time.perf_counter() - t0
    marks = {}

    def mark(what, since=[time.perf_counter()]):
        now = time.perf_counter()
        marks[what] = now - since[0]
        since[0] = now
    card, launches, fit_ms, models = {}, {}, {}, {}
    for name, implicit in (("als_explicit", False), ("als_implicit", True)):
        a, launches[name], s1 = driven(rec_run, M, train_f, implicit)
        b, _, s2 = driven(rec_run, M, train_f, implicit)
        fit_ms[name] = [1e3 * s1, 1e3 * s2]
        ma, mb = a["model"], b["model"]
        if not (np.array_equal(ma.user_factors_arr, mb.user_factors_arr)
                and np.array_equal(ma.item_factors_arr, mb.item_factors_arr)
                and ma.loss_history == mb.loss_history):
            raise AssertionError(f"phase 16: {name} differs between two "
                                 "card runs")
        card[name], models[name] = a, ma
        del b, mb
    mark("card_fits")
    model = models["als_explicit"]
    recs, rec_ms = {}, {}
    for who, call in (("users", model.recommendForAllUsers),
                      ("items", model.recommendForAllItems)):
        recs[who], launches[f"als_recommend_{who}"], s = driven(call,
                                                                 REC_TOP)
        rec_ms[who] = 1e3 * s
    mark("recommend")
    held = {name: models[name].transform(test_f)._column_values(
        "prediction").to(torch.float64) for name in models}
    prof = (profile_run("rec_als", lambda: rec_run(M, train_f, False))
            if profile else None)
    mark("held_out_and_profile")
    t0 = time.perf_counter()
    gates = {}
    with float_policy(torch.float64):
        for name, implicit in (("als_explicit", False),
                               ("als_implicit", True)):
            ref = rec_float64_reference(data["train"], implicit)
            mark(f"{name}_float64_fit")
            loss_err = float(np.max(np.abs(card[name]["loss"]
                                           - np.asarray(ref.loss_history))
                                    / np.abs(ref.loss_history)))
            rmse64 = _rmse(ref, train_f)
            rmse_err = abs(card[name]["rmse"] - rmse64) / rmse64
            want = ref.transform(test_f)._column_values("prediction")
            got = held[name]
            cold = torch.isnan(want)
            if not torch.equal(cold, torch.isnan(got)):
                raise AssertionError(f"phase 16: {name} held-out cold "
                                     "starts differ")
            pred_err = float(torch.max(torch.abs(got - want)[~cold]))
            gates[name] = {"loss_max_rel_err": loss_err,
                           "rmse": card[name]["rmse"],
                           "rmse_float64": rmse64,
                           "rmse_rel_err": rmse_err,
                           "held_out_max_abs_err": pred_err,
                           "held_out_cold": int(cold.sum())}
            if loss_err > REC_RTOL or rmse_err > REC_RTOL \
                    or pred_err > REC_PREDICT_ATOL:
                raise AssertionError(f"phase 16: {name} against float64: "
                                     f"{gates[name]}")
            if not implicit:
                gates["top_users"] = check_top(
                    recs["users"]._column_values("recommendations"), ref,
                    True, "recommendForAllUsers")
                gates["top_items"] = check_top(
                    recs["items"]._column_values("recommendations"), ref,
                    False, "recommendForAllItems")
            del ref
            mark(f"{name}_gates")
    ref_s = time.perf_counter() - t0
    noise = data["noise_rms"]
    share = abs(card["als_explicit"]["rmse"] - noise) / noise
    if share > REC_NOISE_SHARE:
        raise AssertionError(f"phase 16: the explicit fit's training RMSE "
                             f"{card['als_explicit']['rmse']} is not within "
                             f"{REC_NOISE_SHARE} of the planted noise "
                             f"{noise}")
    out = {"users": model.user_factors_arr.shape[0],
           "movies": model.item_factors_arr.shape[0],
           "ratings": data["ratings"], "held_out": data["held_out"],
           "per_user": data["per_user"], "zipf_s": data["zipf_s"],
           "dedupe_rounds": data["dedupe_rounds"],
           "noise_rms": noise, "rmse_share_of_noise": share,
           "fit_ms": fit_ms, "recommend_ms": rec_ms, "launches": launches,
           "losses": {k: [float(card[k]["loss"][0]),
                          float(card[k]["loss"][-1])] for k in card},
           "gates": gates, "profile": prof, "data_s": data_s,
           "steps_s": marks,
           "float64_reference_s": ref_s}
    log(f"phase 16(b) recommender: {json.dumps(out, default=str)}")
    for name in ("als_explicit", "als_implicit"):
        if device == "cuda" and launches[name]["sorted_segment_sum"] == 0:
            raise AssertionError(f"phase 16: {name} launched no "
                                 f"sorted_segment_sum: {launches[name]}")
    return out, data["train"], model


def als_segment_check(data_train: dict, model, device: str = "cuda",
                      runs: int = 5) -> dict:
    """Phase 16(c): the sorted segment sum at a half-step's shapes, built
    from the explicit fit's own factors and the ratings sorted by user and
    by movie (as ``models/recommendation.py`` sorts them once a fit): the
    (nnz, 100) outer products and the (nnz, 10) right-hand sides onto
    138,493 users and onto 26,744 movies. Each case in turn: two float32
    kernel runs bit-identical and within 1e-5 Σ|x| of the float64 plain
    version on the card, the float64 kernel within 1e-12 Σ|x|, one kernel
    a call (``check_one_kernel``), and its times (``segsum_times`` with
    ``runs`` runs a median, index_add_ and torch.segment_reduce beside)."""
    import torch

    from sparkdq4ml_tpu_torch.models import recommendation as R
    from sparkdq4ml_tpu_torch.ops import kernels

    users = data_train["userId"].to(torch.int64)
    items = data_train["movieId"].to(torch.int64)
    _, u_idx = torch.unique(users, sorted=True, return_inverse=True)
    _, i_idx = torch.unique(items, sorted=True, return_inverse=True)
    r = data_train["rating"]
    U = torch.as_tensor(model.user_factors_arr, device=device)
    V = torch.as_tensor(model.item_factors_arr, device=device)
    out = {}
    for side_name, idx_self, idx_other, F, n_self in (
            ("users", u_idx, i_idx, V, U.shape[0]),
            ("movies", i_idx, u_idx, U, V.shape[0])):
        side = R._by_side(idx_self, idx_other, r, n_self)
        size = side.size
        G = F.index_select(0, side.other)
        for what in ("outer products", "right-hand sides"):
            if what == "outer products":
                x = (G[:, :, None] * G[:, None, :]).reshape(G.shape[0], -1)
            else:
                x = G * side.ratings[:, None]
            name = f"ALS {what} onto {size} {side_name}"
            x64 = x.double()
            want = kernels.segment_sum_reference(x64, side.seg, size)
            bound = kernels.segment_sum_reference(x64.abs_(), side.seg,
                                                  size)
            del x64
            errs = {}
            for dtype, rel in ((torch.float32, 1e-5), (torch.float64,
                                                        1e-12)):
                xd = x.to(dtype)
                got = kernels.sorted_segment_sum(xd, side.seg, size)
                again = kernels.sorted_segment_sum(xd, side.seg, size)
                if not same_bits(got, again):
                    raise AssertionError(f"{name} {dtype}: not "
                                         "bit-identical over two runs")
                del again
                diff = (got.double() - want).abs()
                if bool((diff > rel * bound).any()):
                    raise AssertionError(f"{name} {dtype}: exceeds {rel} "
                                         "sum|x|")
                errs[str(dtype)[6:]] = float(diff.max())
                if dtype == torch.float32:
                    one = check_one_kernel("sorted_segment_sum", xd,
                                           side.seg, size)
                del xd, got, diff
            del want, bound
            seg = side.seg
            out[name] = {**segsum_times(name, "sorted_segment_sum", x,
                                        seg, size, runs=runs,
                                        index_add=True),
                         "graph_device_ms": graph_ms(
                             lambda: kernels.sorted_segment_sum(x, seg,
                                                                size), 5, 3),
                         "max_abs_err": errs["float32"],
                         "float64_max_abs_err": errs["float64"],
                         "kernels_a_call": one}
            del x
            torch.cuda.empty_cache()
        del G, side
    log(f"phase 16(c) segment sums at ALS's shapes: "
        f"{json.dumps(out, default=str)}")
    return out


# The JAX package's float32 output (jax.enable_x64(False)) of
# text_rec_small's cases, recomputed by tests/test_torch_text.py.
TEXT_REC_GOLDEN = {
    "als_loss": [1.6009982824325562, 0.3231261074542999, 0.028854768723249435,
                 0.005798960570245981, 0.002187896752730012,
                 0.0012863383162766695, 0.0009692342136986554,
                 0.0008285051444545388, 0.0007548131980001926,
                 0.0007106562261469662, 0.0006810589111410081,
                 0.0006593792932108045, 0.0006424202001653612,
                 0.0006285303388722241, 0.0006167769897729158],
    "als_predictions": [0.5216606855392456, 0.6740745902061462,
                        -0.6956538558006287, 0.15606538951396942,
                        1.0948799848556519, 0.7170532941818237,
                        -0.5638483762741089, 0.1732012778520584],
    "als_top": [[8, 19, 9], [8, 4, 19], [15, 10, 14], [6, 16, 5], [6, 16, 11]],
    "ials_loss": [0.8230360150337219, 0.1428782045841217, 0.10049857199192047,
                  0.08483094722032547, 0.07561894506216049, 0.0672391876578331,
                  0.06026492267847061, 0.055707551538944244,
                  0.0522979199886322, 0.04956291988492012, 0.04725239798426628,
                  0.04539026692509651, 0.04409405589103699,
                  0.04327499493956566, 0.042767707258462906],
    "ials_predictions": [0.946110725402832, 0.9303255081176758,
                         0.9947859048843384, 0.9975287318229675,
                         0.9403082132339478, 0.9677966237068176,
                         0.9732797741889954, 0.9822115302085876],
    "mlp_loss": [0.7192500829696655, 0.29043272137641907, 0.23691946268081665,
                 0.08159654587507248, 0.057334478944540024,
                 0.047602325677871704, 0.041818343102931976,
                 0.037776824086904526, 0.03475132957100868],
    "mlp_accuracy": 0.9875,
    "mlp_probability": [0.9999986886978149, 0.0007213743519969285,
                        2.017372207774315e-05, 1.762089777912479e-05],
    "words": [["the", "tpu", "runs", "fast"], ["the", "cpu", "runs", "slow"],
              None, ["fast", "tpu", "fast"]],
    "tf": [[7, 1.0], [13, 1.0], [15, 1.0], [49, 1.0], [71, 1.0], [79, 2.0],
           [89, 1.0], [205, 1.0], [241, 2.0]],
    "vocabulary": ["fast", "runs", "the", "tpu", "cpu", "slow"],
    "cv": [[0, 1.0], [1, 1.0], [2, 1.0], [3, 1.0], [7, 1.0], [8, 1.0],
           [10, 1.0], [11, 1.0], [18, 2.0], [21, 1.0]],
    "idf": [1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 0.5108256340026855, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 0.5108256340026855, 1.6094379425048828,
            0.5108256340026855, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 0.9162907600402832, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 0.5108256340026855, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828, 1.6094379425048828, 1.6094379425048828,
            1.6094379425048828],
}

TEXT_REC_TOL = 1e-4


def text_rec_small(device: str) -> dict:
    """Small seeded cases of the three modules: tests/test_als.py's planted
    low-rank ratings (explicit) and its implicit data, tests/test_mlp.py's
    XOR fit, and tests/test_text_ovr.py's documents through Tokenizer,
    HashingTF, CountVectorizer and IDF."""
    from sparkdq4ml_tpu_torch import models as M
    from sparkdq4ml_tpu_torch.frame.frame import Frame

    def host(v) -> list:
        return np.asarray(v, np.float64).tolist()

    out = {}
    rng = np.random.default_rng(0)
    U = rng.normal(size=(30, 3))
    V = rng.normal(size=(20, 3))
    R = U @ V.T
    u, i = np.nonzero(rng.random((30, 20)) < 0.6)
    f = Frame({"user": u.astype(np.int32), "item": i.astype(np.int32),
               "rating": R[u, i].astype(np.float32)}, device=device)
    als = M.ALS(rank=3, max_iter=15, reg_param=0.01, seed=1).fit(f)
    out["als_loss"] = host(als.loss_history)
    out["als_predictions"] = host(als.transform(f).to_pydict()[
        "prediction"][:8])
    out["als_top"] = [[int(j) for j, _ in rec] for rec in
                      als.recommendForAllUsers(3).to_pydict()[
                          "recommendations"][:5]]
    rng = np.random.default_rng(0)
    U = rng.normal(size=(40, 3))
    V = rng.normal(size=(30, 3))
    prob = 1 / (1 + np.exp(-2.0 * (U @ V.T)))
    observed = rng.random((40, 30)) < prob * 0.4
    counts = rng.poisson(3.0, size=(40, 30)) + 1
    u, i = np.nonzero(observed)
    f = Frame({"user": u.astype(float), "item": i.astype(float),
               "rating": counts[u, i].astype(float)}, device=device)
    ials = M.ALS(rank=8, max_iter=15, reg_param=0.05, implicit_prefs=True,
                 alpha=10.0, seed=0).fit(f)
    out["ials_loss"] = host(ials.loss_history)
    out["ials_predictions"] = host(ials.transform(f).to_pydict()[
        "prediction"][:8])
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, size=(400, 2))
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.float64)
    f = M.VectorAssembler(["a", "b"], "features").transform(
        Frame({"a": X[:, 0], "b": X[:, 1], "label": y}, device=device))
    mlp = M.MultilayerPerceptronClassifier(layers=[2, 8, 2], max_iter=800,
                                           step_size=0.05, seed=1).fit(f)
    d = mlp.transform(f).to_pydict()
    out["mlp_loss"] = host(mlp.loss_history[::100] + mlp.loss_history[-1:])
    out["mlp_accuracy"] = float(np.mean(np.asarray(d["prediction"]) == y))
    out["mlp_probability"] = host(np.asarray(d["probability"])[:4, 1])
    docs = np.asarray(["the TPU runs Fast", "the cpu runs slow", None,
                       "fast tpu fast"], dtype=object)
    f = M.Tokenizer("text", "words").transform(
        Frame({"text": docs}, device=device))
    out["words"] = [None if w is None else list(w)
                    for w in f.to_pydict()["words"]]
    f = M.HashingTF(64, "words", "tf").transform(f)
    tf = np.asarray(f.to_pydict()["tf"], np.float64)
    out["tf"] = [[int(j), float(tf.flat[j])]
                 for j in np.flatnonzero(tf.reshape(-1))]
    cv = M.CountVectorizer(input_col="words", output_col="cv").fit(f)
    out["vocabulary"] = list(cv.vocabulary)
    cm = np.asarray(cv.transform(f).to_pydict()["cv"], np.float64)
    out["cv"] = [[int(j), float(cm.flat[j])]
                 for j in np.flatnonzero(cm.reshape(-1))]
    idf = M.IDF(input_col="tf", output_col="tfidf").fit(f)
    out["idf"] = host(idf.idf)
    return out


TEXT_REC_EXACT = ("als_top", "mlp_accuracy", "words", "tf", "vocabulary",
                  "cv")


def text_rec_errors(got: dict, want: dict) -> dict:
    """Each float entry's largest error, relative to max(1, |want|)."""
    errs = {}
    for k, v in want.items():
        if k in TEXT_REC_EXACT:
            continue
        a = np.asarray(got[k], np.float64)
        b = np.asarray(v, np.float64)
        if a.shape != b.shape:
            errs[k] = float("inf")
            continue
        errs[k] = float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))
    return errs


def check_text_rec_golden(device: str) -> dict:
    """Phase 16(d): text_rec_small on the card against TEXT_REC_GOLDEN:
    ids, vocabularies, counts and the accuracy exact, floats within
    TEXT_REC_TOL."""
    got = text_rec_small(device)
    bad = [k for k in TEXT_REC_EXACT if got[k] != TEXT_REC_GOLDEN[k]]
    errs = text_rec_errors(got, TEXT_REC_GOLDEN)
    bad += [f"{k} off by {e}" for k, e in errs.items() if e > TEXT_REC_TOL]
    log(f"phase 16(d) against TEXT_REC_GOLDEN, {device} float32: errors "
        f"{errs}")
    if bad:
        raise AssertionError(f"phase 16 against TEXT_REC_GOLDEN: {bad}")
    return {"errors": errs}


# ---------------------------------------------------------------------------
# Phase 17: the fused pipeline under the reference app
# ---------------------------------------------------------------------------

# The last line of examples/dq4ml_pipeline.py on each dataset: the JAX
# package's output on the CPU (tests/test_torch_app_report.py recomputes
# it), from a fresh process.
APP_REPORT_GOLDEN = {
    name: ("pipeline counters: {'pipeline.flush': 9, 'pipeline.compile': 3, "
           "'pipeline.hit': 6}")
    for name in ("abstract", "small", "full")}
PIPELINE_SMALL_ROWS = 1040
PIPELINE_FULL_RUNS = 3          # steady DQ phase at 10^7 rows, each way
PIPELINE_SMALL_RUNS = 21        # and at 1,040 rows
PIPELINE_TRACED = 20            # flushes under one profiler trace, each way
PIPELINE_HOST_RUNS = 200        # calls a piece of a flush's host time
RULE_1_SQL = ("SELECT cast(guest as int) guest, price_no_min AS price "
              "FROM price WHERE price_no_min > 0")
RULE_2_SQL = ("SELECT guest, price_correct_correl AS price "
              "FROM price WHERE price_correct_correl > 0")


def fresh_pipeline() -> int:
    """Clear the plan cache, the pipeline and frame counters and the
    statstore, as in a fresh process; returns the fallbacks counted
    until then."""
    from sparkdq4ml_tpu_torch.ops import compiler
    from sparkdq4ml_tpu_torch.utils import statstore
    from sparkdq4ml_tpu_torch.utils.profiling import counters

    fallbacks = counters.get("pipeline.fallback")
    compiler.clear_cache()
    counters.clear("pipeline.")
    counters.clear("frame.")
    statstore.STORE.clear()
    return fallbacks


def dq_phase(spark, df):
    """The app's DQ phase (``dq_phase`` of examples/dq4ml_pipeline.py):
    both rules and both SQL clean-ups."""
    import sparkdq4ml_tpu_torch as dq

    d = df.with_column("price_no_min",
                       dq.call_udf("minimumPriceRule", df.col("price")))
    d.create_or_replace_temp_view("price")
    d = spark.sql(RULE_1_SQL)
    d = d.with_column("price_correct_correl",
                      dq.call_udf("priceCorrelationRule", d.col("price"),
                                  d.col("guest")))
    d.create_or_replace_temp_view("price")
    return spark.sql(RULE_2_SQL)


def pipeline_setting(on: bool):
    """The pipeline on or off for a block, as spark.pipeline.enabled sets
    it."""
    import contextlib

    from sparkdq4ml_tpu_torch.config import config

    @contextlib.contextmanager
    def block():
        old = config.pipeline
        config.pipeline = on
        try:
            yield
        finally:
            config.pipeline = old
    return block()


def timed_both_ways(fn, runs: int) -> dict:
    """Median host-clock ms of ``fn()`` (ended by a synchronisation), with
    the pipeline on and off in turns, after one warm-up each way."""
    import torch

    times = {True: [], False: []}
    for r in range(runs + 1):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            with pipeline_setting(on):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if r:
                    times[on].append(1e3 * (time.perf_counter() - t0))
    return {"on_ms": float(np.median(times[True])),
            "off_ms": float(np.median(times[False])),
            "on_runs_ms": times[True], "off_runs_ms": times[False]}


def check_app_report() -> dict:
    """Phase 17(a): ``python -m sparkdq4ml_tpu_torch.app`` on the three
    datasets, each from a fresh pipeline state: its report's last line
    equal to APP_REPORT_GOLDEN, its RMSE, r2 and predict(40) and the row
    counts of its DQ phase against GOLDEN."""
    import contextlib
    import io

    from sparkdq4ml_tpu_torch import TorchSession, app

    out = {}
    fallbacks = 0
    for name, (rows, rmse, r2, p40) in GOLDEN.items():
        fallbacks += fresh_pipeline()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            app.start(os.path.join(ROOT, "data", f"dataset-{name}.csv"))
        lines = buf.getvalue().splitlines()
        if lines[-1] != APP_REPORT_GOLDEN[name]:
            raise AssertionError(f"app report {name}: {lines[-1]!r} != "
                                 f"{APP_REPORT_GOLDEN[name]!r}")

        def value(prefix):
            return float(next(line for line in lines
                              if line.startswith(prefix))[len(prefix):])

        got = {"RMSE": value("RMSE: "), "r2": value("r2: "),
               "predict(40)": float(lines[-3].rsplit(" ", 1)[1])}
        for what, want in (("RMSE", rmse), ("r2", r2), ("predict(40)", p40)):
            if abs(got[what] - want) > 1e-3 * abs(want):
                raise AssertionError(f"app report {name}: {what} "
                                     f"{got[what]} vs {want}")
        spark = TorchSession.active()
        counts = (read_dataset(spark, name).count(),
                  spark.table("price").count(),
                  spark.sql(RULE_2_SQL).count())
        if counts != rows:
            raise AssertionError(f"app report {name}: rows {counts} != "
                                 f"{rows}")
        out[name] = {**got, "rows": counts, "last_line": lines[-1],
                     "wall_clock_line": lines[-2]}
        spark.stop()
    log(f"phase 17(a) app reports: {out}")
    return {"reports": out, "fallbacks_before": fallbacks}


def frame_bits(frame) -> dict:
    import torch

    return {c: frame._column_values(c) for c in frame.columns
            if isinstance(frame._column_values(c), torch.Tensor)}


def frame_differences(a, b) -> list:
    """The columns (and ``mask``) in which two frames differ, bit for
    bit."""
    import torch

    x, y = frame_bits(a), frame_bits(b)
    out = [c for c in x if c not in y or x[c].dtype != y[c].dtype
           or x[c].shape != y[c].shape or not same_bits(x[c], y[c])]
    out += [c for c in y if c not in x]
    if not torch.equal(a.mask, b.mask):
        out.append("mask")
    return out


def app_on_off(spark, df, where: str) -> dict:
    """The app path with the pipeline on and off (spark.pipeline.enabled):
    every column and the mask of the clean frame and the fit's numbers
    must be bit-identical. Returns the run's counts and the statstore's
    entries of each way."""
    from sparkdq4ml_tpu_torch.utils import statstore

    res = {}
    for on in (True, False):
        with pipeline_setting(on):
            statstore.STORE.clear()
            counts = []
            clean, model, p40 = app_path(spark, df, counts)
            res[on] = {"frame": clean, "counts": counts,
                       "numbers": (model.coefficients[0], model.intercept,
                                   model.summary.rootMeanSquaredError, p40),
                       "stats": statstore.STORE.report()["entries"]}
    on, off = res[True], res[False]
    differ = frame_differences(on["frame"], off["frame"])
    if on["numbers"] != off["numbers"]:
        differ.append(f"fit {on['numbers']} vs {off['numbers']}")
    if differ:
        raise AssertionError(f"phase 17{where}: pipeline on against off "
                             f"differ at {df.num_slots} rows: {differ}")
    if off["stats"]:
        raise AssertionError(f"phase 17{where}: the eager path recorded "
                             f"{off['stats']}")
    return res


def check_pipeline_full(full: dict, rows: int = FULL_ROWS) -> dict:
    """Phase 17(b): the app path at 10^7 rows with the pipeline on and off
    (``app_on_off``); the steady DQ phase both ways; the statstore's two
    WHERE selectivities equal to the run's kept/in counts, the second to
    phase 5's."""
    from sparkdq4ml_tpu_torch.ops import compiler

    guest, price = full_table(rows)
    spark = session("cuda")
    df = spark.create_data_frame({"guest": guest, "price": price})
    on = app_on_off(spark, df, "(b)")[True]
    n, kept1, kept2 = on["counts"]
    if kept2 != full["kept"]:
        raise AssertionError(f"phase 17(b): kept {kept2} != phase 5's "
                             f"{full['kept']}")
    filters = {("price_no_min" if "price_no_min" in e["key"] else
                "price_correct_correl"): e for e in on["stats"]
               if e["kind"] == "filter"}
    sel = {}
    for col, kept in (("price_no_min", kept1),
                      ("price_correct_correl", kept2)):
        e = filters[col]
        k = e["sel_observations"]
        if k < 1 or e["rows_in"] != k * n or e["rows_out"] != k * kept:
            raise AssertionError(f"phase 17(b): WHERE {col} > 0 recorded "
                                 f"{e}, expected {k} x ({kept} of {n})")
        sel[col] = {"selectivity": e["selectivity"], "kept": kept,
                    "rows": n, "observations": k}
    steady = timed_both_ways(lambda: dq_phase(spark, df).mask,
                             PIPELINE_FULL_RUNS)
    buckets = {e["program_key"]: sorted(e["buckets"])
               for e in compiler.cache_stats()["entries"]}
    spark.stop()
    out = {"rows": rows, "bit_identical": True, "selectivity": sel,
           "steady_dq_phase": steady, "plan_buckets": buckets}
    log(f"phase 17(b) at {rows} rows: {out}")
    return out


def flush_trace(fn, calls: int = PIPELINE_TRACED) -> dict:
    """``calls`` calls of ``fn`` under one torch.profiler trace: the
    launches a call makes on the host (kernels, copies, memsets) and the
    device kernels it runs, with their names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = {"kernel": ("cudaLaunchKernel", "cuLaunchKernel",
                        "cudaLaunchKernelExC"),
             "memcpy": ("cudaMemcpyAsync",),
             "memset": ("cudaMemsetAsync",)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    on_device = [e for e in events
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
    host = {k: sum(e.name in v for e in events) / calls
            for k, v in names.items()}
    return {"host_launches": host,
            "device_kernels": len(on_device) / calls,
            "device_kernel_names": sorted({e.name for e in on_device}),
            "device_ms": 1e-3 * sum(e.time_range.elapsed_us()
                                    for e in on_device) / calls}


def literal_turns(spark, d1) -> dict:
    """One plan run at two hoisted literals in turns (WHERE price_no_min >
    0 and > 50), every result frame kept until all have run; each held
    against its eager run bit for bit. Returns the kept rows a literal
    and the plan's compiles and hits."""
    from sparkdq4ml_tpu_torch.utils.profiling import counters

    sql = RULE_1_SQL.replace("> 0", "> {}")
    before = (counters.get("pipeline.compile"), counters.get("pipeline.hit"))
    frames = []
    for lit in (0, 50, 0, 50):
        d1.create_or_replace_temp_view("price")
        f = spark.sql(sql.format(lit))
        f._data
        frames.append((lit, f))
    compiles = counters.get("pipeline.compile") - before[0]
    hits = counters.get("pipeline.hit") - before[1]
    kept = {}
    with pipeline_setting(False):
        for lit, f in frames:
            d1.create_or_replace_temp_view("price")
            differ = frame_differences(f, spark.sql(sql.format(lit)))
            if differ:
                raise AssertionError(f"phase 17(c): WHERE price_no_min > "
                                     f"{lit} differs from eager at "
                                     f"{differ}")
            kept[lit] = f.count()
    if kept[0] == kept[50] or compiles > 1 or compiles + hits != 4:
        raise AssertionError(f"phase 17(c): literal turns kept {kept} "
                             f"with {compiles} compiles, {hits} hits")
    return {"kept": kept, "compiles": compiles, "hits": hits}


def flush_host_us(fn, runs: int = PIPELINE_HOST_RUNS) -> float:
    """Median host-clock microseconds of ``fn()``, the card idle before
    each call (the launches it queues are not waited for)."""
    import torch

    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e6 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return float(np.median(times[1:]))


def flush_breakdown(spark, d1) -> dict:
    """The host time of a hit flush of RULE_1_SQL's plan (its WHERE as a
    deferred filter, its cast as the fused projection), piece by piece:
    the query both ways, the deferral of the filter (``Frame._defer``,
    which lowers its predicate once), the lowering of the projection
    (``compiler.lower``), ``run_pipeline`` whole, and its parts, the
    cache probe (``_lookup_plan``, which joins the steps' lowerings into
    the plan key), the plan's steps (``_Plan.run``) and the statstore's
    record (``_record_flush_stats``)."""
    import sparkdq4ml_tpu_torch as dq
    from sparkdq4ml_tpu_torch.frame.frame import _step_names
    from sparkdq4ml_tpu_torch.ops import compiler

    pred = dq.col("price_no_min") > 0
    cast = dq.col("guest").cast("int")
    f = d1.filter(pred)
    steps, data, mask, n = f._pending, f._data_store, f._mask_store, f._n
    schema = compiler.LazySchema(data, _step_names(steps))
    extra = (("__sel_0", cast, compiler.lower(cast, schema)),)
    plan, lits = compiler._lookup_plan(steps, extra)
    b = compiler.bucket_size(n)

    def query():
        d1.create_or_replace_temp_view("price")
        return spark.sql(RULE_1_SQL)._data

    out = {}
    with pipeline_setting(False):
        out["query_off"] = flush_host_us(query)
    out["query_on"] = flush_host_us(query)
    out["defer_filter"] = flush_host_us(lambda: d1.filter(pred))
    out["lower_projection"] = flush_host_us(lambda: compiler.lower(
        cast, compiler.LazySchema(data, _step_names(steps))))
    out["run_pipeline"] = flush_host_us(
        lambda: compiler.run_pipeline(data, mask, n, steps, extra))
    out["lookup_plan"] = flush_host_us(
        lambda: compiler._lookup_plan(steps, extra))
    out["plan_run"] = flush_host_us(
        lambda: plan.run(data, mask, n, b, lits, mask.device))
    out["record_stats"] = flush_host_us(
        lambda: compiler._record_flush_stats(plan, data, b, n, 0.0, False,
                                             mask))
    out["rest_of_run_pipeline"] = (out["run_pipeline"] - out["lookup_plan"]
                                   - out["plan_run"] - out["record_stats"])
    return out


def check_pipeline_small(rows: int = PIPELINE_SMALL_ROWS) -> dict:
    """Phase 17(c): at 1,040 rows: the app path on against off bit for bit
    (``app_on_off``); one plan at two hoisted literals in turns
    (``literal_turns``); the kernels a flush of the first clean-up runs
    both ways (the kernel nodes of a CUDA graph captured from it, and the
    launches and device kernels under torch.profiler); the host time of
    a hit flush piece by piece (``flush_breakdown``); the steady DQ phase
    both ways; no synchronizing call in a hit flush."""
    import sparkdq4ml_tpu_torch as dq

    guest, price = full_table(rows, seed=1)
    spark = session("cuda")
    df = spark.create_data_frame({"guest": guest, "price": price})
    app_on_off(spark, df, "(c)")
    d1 = df.with_column("price_no_min",
                        dq.call_udf("minimumPriceRule", df.col("price")))
    d1._data

    def run():
        d1.create_or_replace_temp_view("price")
        return spark.sql(RULE_1_SQL)._data

    run()
    out = {"bit_identical": True, "literal_turns": literal_turns(spark, d1)}
    with pipeline_setting(False):
        run()
        eager = flush_trace(run)
        eager_nodes = graph_kernels(run)
    piped = flush_trace(run)
    piped_nodes = graph_kernels(run)
    syncs = host_syncs(run)
    if syncs:
        raise AssertionError(f"phase 17(c): a hit flush of rule 1's query "
                             f"made {syncs} synchronizing calls")
    out["rule_1_sql"] = {"pipeline_kernel_nodes": piped_nodes[0],
                         "pipeline_memset_nodes": piped_nodes[1],
                         "eager_kernel_nodes": eager_nodes[0],
                         "eager_memset_nodes": eager_nodes[1],
                         "pipeline_trace": piped, "eager_trace": eager,
                         "hit_flush_syncs": syncs}
    out["flush_host_us"] = flush_breakdown(spark, d1)
    out["steady_dq_phase"] = timed_both_ways(
        lambda: dq_phase(spark, df).mask, PIPELINE_SMALL_RUNS)
    spark.stop()
    log(f"phase 17(c) at {rows} rows: {out}")
    return out


def pipeline_totals(fallbacks_before: int) -> dict:
    """Phase 17(d): the pipeline's counters since the last fresh state and
    the fallbacks over the whole script (none may have happened)."""
    from sparkdq4ml_tpu_torch.ops import compiler
    from sparkdq4ml_tpu_torch.utils.profiling import counters

    out = {"fallbacks": fallbacks_before
           + counters.get("pipeline.fallback"),
           **{k: counters.get(f"pipeline.{k}")
              for k in ("flush", "compile", "hit", "evict")},
           "plans": compiler.cache_stats()["size"]}
    log(f"phase 17(d): {out}")
    if out["fallbacks"]:
        raise AssertionError(f"the pipeline fell back to eager replay "
                             f"{out['fallbacks']} times")
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


def device_time(fn) -> dict:
    """The device time of one call of ``fn``: from CUDA graph replays
    (``graph_ms``, the kernels alone, no host path) and from profiler
    traces of single calls (``traced_calls``; None where every trace lost
    its device events, as traces late in this script do)."""
    got = traced_calls(fn)
    return {"device_ms": graph_ms(fn), "traced_device_ms": got["device_ms"],
            "device_events": got["device_events"],
            "traces_kept": got["traces_kept"]}


def dq_times(n: int, device: bool = False) -> dict:
    """``device``: also the device time of single calls (``device_time``)."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    price, guest = dq_inputs(n, torch.float32, "cuda", seed=7)
    moved = n * (4 + 4 + 4 + 4 + 1)
    extra = (device_time(lambda: kernels.dq_rules(price, guest)) if device
             else {})
    return {**extra, "n": n, "dtype": "float32",
            "ms": median_ms(lambda: kernels.dq_rules(price, guest)),
            "plain_ms": median_ms(
                lambda: kernels.dq_rules_reference(price, guest)),
            "library_ms": None,
            "bound_ms": 1e3 * moved / HBM_BYTES_PER_S, "bound_by": "bytes"}


def gram_times(n: int, D: int, device: bool = False) -> dict:
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    Z = packed_design(n, D, torch.float32, "cuda", seed=11)
    t_bytes = (n * D + D * D) * 4 / HBM_BYTES_PER_S
    t_ops = n * D * (D + 1) / FP32_FLOPS    # one triangle of symmetric A
    extra = device_time(lambda: kernels.packed_gram(Z)) if device else {}
    return {**extra, "n": n, "D": D, "dtype": "float32",
            "ms": median_ms(lambda: kernels.packed_gram(Z)),
            "plain_ms": median_ms(lambda: kernels.packed_gram_reference(Z)),
            "library_ms": median_ms(lambda: torch.matmul(Z.T, Z)),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def masked_times(n: int, d: int, weights: str = "bool",
                 device: bool = False) -> dict:
    """masked_gram with a boolean mask (the cross-validation's and the
    unweighted Huber fit's weight) or float weights (phase 15's √w).
    library_ms is one torch.matmul on a pre-built Zw, the packing
    excluded."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    X, y, w = masked_inputs(n, d, torch.float32, "cuda", 13, weights)
    D = d + 2
    Zw = torch.cat([X, y[:, None], torch.ones_like(y)[:, None]],
                   dim=1) * w.to(X.dtype)[:, None]
    # X, y in float32 and the weight (1 byte or 4) read once; A written
    # once
    t_bytes = (n * ((d + 1) * 4 + w.element_size()) + D * D * 4) \
        / HBM_BYTES_PER_S
    t_ops = n * D * (D + 1) / FP32_FLOPS    # one triangle of symmetric A
    extra = (device_time(lambda: kernels.masked_gram(X, y, w)) if device
             else {})
    return {**extra, "n": n, "d": d, "dtype": "float32", "weights": weights,
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
                "dense_segment_sum": ("dense_regs", "dense_table"),
                "sorted_segment_sum": ("sorted_segments",)}


def profile_run(name: str, fn) -> dict:
    """One run of ``fn`` under torch.profiler: device busy time over the
    run's wall time, the wrappers whose kernels the trace holds (the busy
    time counts only those), and the kernel table written to
    chiprun_out/<name>_profile.txt. The profiler's own cost is inside the
    wall time. Where the trace holds no device event, the busy time and
    the idle share are None: not measured."""
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
    # the copies by kind, e.g. "Memcpy HtoD (Pinned -> Device)"
    copies = {e.key: e.count for e in on_device if "memcpy" in e.key.lower()}
    # a trace that recorded no device event measured no busy time
    busy_ms = (1e-3 * sum(e.self_device_time_total for e in on_device)
               if on_device else None)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{name}_profile.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=60))
    kernel_ms = {name: 1e-3 * sum(e.self_device_time_total
                                  for e in on_device
                                  if any(p in e.key for p in parts))
                 for name, parts in KERNEL_NAMES.items()}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (None if busy_ms is None
                                  else 1.0 - busy_ms / wall_ms),
            "device_events": len(on_device), "copies": copies,
            "port_kernel_ms": {k: v for k, v in kernel_ms.items() if v},
            "port_kernels_in_trace": sorted(
                name for name, parts in KERNEL_NAMES.items()
                if any(p in listed for p in parts))}


# Traces of one wrapper call that trace_call takes at most: the profiler
# has been seen to drop one kernel of a two-kernel call, and, late in the
# script, the kernel of a one-kernel call.
PROFILE_RETRACES = 3


def trace_call(fn) -> dict:
    """One call of ``fn`` under a torch.profiler trace of its own: the
    device events it runs, the kernel launches its host side makes, and
    the device time of those events (ms). A trace that holds fewer device
    events than host launches and memsets lost events: the call is traced
    again, up to ``PROFILE_RETRACES`` times, and ``traces`` says how many
    were taken."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for taken in range(1, PROFILE_RETRACES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        on_device = [e for e in events
                     if str(getattr(e, "device_type", "")).endswith("CUDA")]
        launched = sum(e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                  "cudaLaunchKernelExC") for e in events)
        memsets = sum(e.name == "cudaMemsetAsync" for e in events)
        if len(on_device) >= launched + memsets:
            break
    return {"device_kernels": len(on_device), "host_launches": launched,
            "names": sorted({e.name for e in on_device}), "traces": taken,
            "device_ms": 1e-3 * sum(e.time_range.elapsed_us()
                                    for e in on_device)}


def device_kernels_per_call(name: str, *args) -> dict:
    """The device kernels that one call of the wrapper ``name`` on ``args``
    runs, and the kernel launches its host side makes, from a
    torch.profiler trace of that call alone (``trace_call``), after a
    warm-up call."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    fn = getattr(kernels, name)
    fn(*args)                                           # warm-up
    torch.cuda.synchronize()
    got = trace_call(lambda: fn(*args))
    return {k: got[k] for k in ("device_kernels", "host_launches", "names",
                                "traces")}


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

    reference = CpuReference()
    try:
        t0 = time.perf_counter()
        kernels.build()
        log(f"build (beside the CPU references): "
            f"{time.perf_counter() - t0:.1f} s")
        waited = reference.wait()
        log(f"CPU float64 references of phases 7-8, 11 and 12 ready, "
            f"{waited:.1f} s waited for after the build")
        return run_phases(card, reference, script_t0, waited)
    finally:
        reference.stop()


def run_phases(card: str, reference: "CpuReference", script_t0: float,
               reference_wait_s: float) -> int:
    """Phases 3 to 17 and the last lines; ``reference`` holds the CPU
    float64 runs of phases 7-8, 11 and 12, all ready."""
    import torch

    # First, while no other profiler session has run in this process.
    per_call = gram_kernel_counts()

    dq_err = check_dq_rules("cuda")
    gram_errs = check_packed_gram("cuda")
    masked_errs = check_masked_gram("cuda")
    check_segment_sum(edge_segment_cases("cuda"))
    two_streams = check_two_streams()
    log(f"segment sums on two streams: {two_streams}")
    seg_cases = segment_cases(*clean_columns())
    seg_errs = check_segment_sum(seg_cases)
    one_cases = one_slot_cases()
    one_errs = check_segment_sum(one_cases)
    check_goldens("cuda")
    full, plain, counts, app_s, stages = check_full()
    log(f"app phase at {FULL_ROWS} rows, card float32, s: {app_s}; "
        f"launches of the first run {counts}")
    t0 = time.perf_counter()
    selection = check_model_selection()
    selection_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    small = {"dataset_full": check_dataset_full("cuda"),
             "owlqn": check_owlqn("cuda")}
    small_s = time.perf_counter() - t0

    dq_main, dq_app = dq_times(FULL_ROWS, device=True), dq_times(40)
    gram_main, gram_app, gram_big = (gram_times(FULL_ROWS, 3, device=True),
                                     gram_times(40, 3),
                                     gram_times(1_000_000, 514))
    masked_main, masked_app, masked_big = (
        masked_times(FULL_ROWS, 1, device=True), masked_times(1040, 1),
        masked_times(1_000_000, 512))
    masked_feature = masked_times(FULL_ROWS, 14, "float", device=True)
    log("device times of the TPU kernels' ports at their main shapes: "
        + str([(r["n"], r.get("D", r.get("d")), r["ms"], r["device_ms"])
               for r in (dq_main, gram_main, masked_main, masked_feature)]))
    seg_dense, seg_sorted, seg_long = (segsum_times(*c) for c in seg_cases)
    seg_one = {c[0]: {**segsum_times(*c), "max_abs_err": one_errs[c[0]]}
               for c in one_cases}
    seg_host = segsum_host_path(one_cases)
    zero_forms = sorted_zero_forms()
    del seg_cases, one_cases
    prof = profile_app()
    log(f"profile of the app phase: {prof}")
    tour = check_tour_golden("cuda")
    cpu, cpu_timing = reference.result("sql")
    cpu_s = cpu_timing["reference_s"]
    log(f"cpu float64 reference: {cpu_timing}")
    t0 = time.perf_counter()
    sql_core = check_sql_core_full(cpu)
    sql_core_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sql_rest = check_sql_rest_full(cpu)
    sql_rest_s = time.perf_counter() - t0
    del cpu
    t0 = time.perf_counter()
    tour_classifiers = check_ml_tour_golden("cuda")
    classifiers = check_classifiers_full()
    classifiers_s = time.perf_counter() - t0
    have = optional_modules()
    log(f"optional modules: {have}")
    t0 = time.perf_counter()
    ingest = check_ingest(full, plain, have)
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = check_report_full(*full_table(FULL_ROWS), reference)
    report_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    builtins = check_builtins_full(*full_table(FULL_ROWS), reference)
    builtins_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    argmax_first_on_card()
    zoo_tour_res = check_zoo_tour_golden("cuda")
    zoo = check_zoo_full()
    zoo_s = time.perf_counter() - t0
    zoo_cases = zoo_segment_cases()
    zoo_errs = check_segment_sum(zoo_cases)
    zoo_times = {c[0]: {**segsum_times(*c), "kernel": c[1],
                        "max_abs_err": zoo_errs[c[0]]} for c in zoo_cases}
    del zoo_cases
    t0 = time.perf_counter()
    rest_tour_res = check_rest_tour_golden("cuda")
    rest = check_rest_full()
    rest_s = time.perf_counter() - t0
    rest_cases = rest_segment_cases()
    rest_errs = check_segment_sum(rest_cases)
    rest_times = {c[0]: {**segsum_times(*c), "kernel": c[1],
                         "max_abs_err": rest_errs[c[0]]} for c in rest_cases}
    del rest_cases
    t0 = time.perf_counter()
    features = check_features_full()
    features_s = time.perf_counter() - t0
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    text_rec_gold = check_text_rec_golden("cuda")
    text = check_text_full()
    rec, rec_train, rec_model = check_rec_full()
    text_rec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    als_shapes = als_segment_check(rec_train, rec_model)
    del rec_train, rec_model
    gc.collect()
    torch.cuda.empty_cache()
    als_segment_s = time.perf_counter() - t0
    log(f"phase 16: {text_rec_s:.1f} s, its segment-sum cases "
        f"{als_segment_s:.1f} s")
    t0 = time.perf_counter()
    app_report = check_app_report()
    pipeline_full = check_pipeline_full(full)
    pipeline_small = check_pipeline_small()
    pipeline = pipeline_totals(app_report["fallbacks_before"])
    pipeline_s = time.perf_counter() - t0
    log(f"phase 17: {pipeline_s:.1f} s")
    zoo_launches = {name: zoo["launches"][name]
                    for name in ("glm", "gbt", "rf", "dt", "kmeans", "gmm",
                                 "bisecting", "pic")}
    by_path = {"app": counts,
               **{p: selection[p]["launches"] for p in selection},
               "owlqn_dataset_full": small["owlqn"]["full"]["l-bfgs"][
                   "launches"],
               "sql_core": sql_core["launches"],
               "sql_rest": sql_rest["launches"],
               "classifier_table": classifiers["clean_launches"],
               **{f"classifier_{name}": fit["launches"]
                  for name, fit in classifiers["fits"].items()},
               "ingest_app": ingest["launches"],
               "dq_report": report["launches"],
               "builtins": builtins["launches"],
               **{f"zoo_{name}": c for name, c in zoo_launches.items()},
               "rest_clean_table": rest["clean_launches"],
               **{f"rest_{name}": c for name, c in rest["launches"].items()},
               "feature_clean_table": features["clean_launches"],
               **{f"feature_{name}": c
                  for name, c in features["launches"].items()},
               "text_pipeline": text["text_launches"],
               "text_mlp": text["mlp_launches"],
               **{f"rec_{name}": c for name, c in rec["launches"].items()}}
    feature_launches = {k: {name: c[k]
                            for name, c in features["launches"].items()}
                        for k in ("dense_segment_sum", "masked_gram")}
    one_slot_launches = {path: c.get("dense_segment_sum_one_slot", 0)
                         for path, c in by_path.items()}
    log(f"dense_segment_sum launches onto one slot, by path: "
        f"{one_slot_launches}")
    kernels_line = {"kernels": [
        {"name": "dq_rules", "route": "cuda",
         "source": "sparkdq4ml_tpu_torch/ops/csrc/dq_rules.cu",
         "replaces": "sparkdq4ml_tpu/ops/pallas_kernels.py:237",
         "launches": counts["dq_rules"], "max_abs_err": dq_err,
         "dq_report_launches": report["launches"]["dq_rules"],
         "builtins_launches": builtins["launches"]["dq_rules"],
         "rest_launches": rest["clean_launches"]["dq_rules"],
         "feature_launches": features["clean_launches"]["dq_rules"],
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
         "zoo_glm_launches": zoo_launches["glm"]["masked_gram"],
         "zoo_glm_irls_iterations": zoo["fits"]["glm"]["iterations"],
         "feature_launches": feature_launches["masked_gram"],
         "feature_shape": masked_feature,
         "max_abs_err": masked_errs[(FULL_ROWS, 1)],
         "parity": True, **masked_main, "app_size": masked_app,
         "largest": masked_big},
        {"name": "dense_segment_sum", "route": "cuda", "port_only": True,
         "source": "sparkdq4ml_tpu_torch/ops/csrc/segment_sum.cu",
         "replaces": "sparkdq4ml_tpu/ops/segments.py:728 "
                     "(jax.ops.segment_sum, an XLA scatter, no pallas_call)",
         "launches": sql_core["launches"]["dense_segment_sum"],
         "dq_report_launches": report["launches"]["dense_segment_sum"],
         "zoo_launches": {name: c["dense_segment_sum"]
                          for name, c in zoo_launches.items()},
         "zoo_shapes": {k: v for k, v in zoo_times.items()
                        if v["kernel"] == "dense_segment_sum"},
         "rest_launches": {name: c["dense_segment_sum"]
                           for name, c in rest["launches"].items()},
         "feature_launches": feature_launches["dense_segment_sum"],
         "als_launches": {name: c["dense_segment_sum"]
                          for name, c in rec["launches"].items()},
         "one_slot_launches": one_slot_launches,
         "max_abs_err": seg_errs["dense 39 slots"], "parity": True,
         "bit_identical_runs": True, **seg_dense, "one_slot": seg_one,
         "one_slot_host_path": seg_host},
        {"name": "sorted_segment_sum", "route": "cuda", "port_only": True,
         "source": "sparkdq4ml_tpu_torch/ops/csrc/segment_sum.cu",
         "replaces": "sparkdq4ml_tpu/ops/segments.py:1026 "
                     "(jax.ops.segment_sum, an XLA scatter, no pallas_call)",
         "launches": sql_core["launches"]["sorted_segment_sum"],
         "dq_report_launches": report["launches"]["sorted_segment_sum"],
         "zoo_launches": {name: c["sorted_segment_sum"]
                          for name, c in zoo_launches.items()},
         "zoo_shapes": {k: v for k, v in zoo_times.items()
                        if v["kernel"] == "sorted_segment_sum"},
         "rest_launches": {name: c["sorted_segment_sum"]
                           for name, c in rest["launches"].items()},
         "rest_shapes": rest_times,
         "als_launches": {name: c["sorted_segment_sum"]
                          for name, c in rec["launches"].items()},
         "als_shapes": als_shapes,
         "max_abs_err": seg_errs["sorted price groups"], "parity": True,
         "bit_identical_runs": True, "two_streams": two_streams,
         "zero_forms": zero_forms,
         **seg_sorted, "long_segments": seg_long},
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
        "ml_tour_dataset_full": tour_classifiers,
        "classifiers": classifiers, "classifiers_phase_s": classifiers_s,
        "ingest": ingest, "ingest_phase_s": ingest_s,
        "dq_report": report, "dq_report_phase_s": report_s,
        "builtins": builtins, "builtins_phase_s": builtins_s,
        "zoo_tour_dataset_full": zoo_tour_res, "zoo": zoo,
        "zoo_phase_s": zoo_s,
        "rest_tour_dataset_full": rest_tour_res, "rest": rest,
        "rest_phase_s": rest_s,
        "features": features, "features_phase_s": features_s,
        "text_rec_golden": text_rec_gold, "text": text, "recommender": rec,
        "text_rec_phase_s": text_rec_s, "als_segment_s": als_segment_s,
        "pipeline": {"app_report": app_report["reports"],
                     "full": pipeline_full, "small": pipeline_small,
                     "totals": pipeline},
        "pipeline_phase_s": pipeline_s,
        "optional_modules": have,
        "cpu_float64_reference_s": cpu_s,
        "cpu_float64_reference_wait_s": reference_wait_s,
        "cpu_float64_reference_timing": cpu_timing,
        "script_s": time.perf_counter() - script_t0, "card": card}
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_smoke.json"), "w") as f:
        json.dump(kernels_line, f)
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
