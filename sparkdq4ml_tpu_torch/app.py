"""The reference application on the port (``examples/dq4ml_pipeline.py``,
line for line): session init, UDF registration, CSV load (bare-CR), two
DQ rules + SQL clean-ups, label column, VectorAssembler, Lasso
LinearRegression (maxIter=40, regParam=1, elasticNetParam=1),
transform/show, training summary and the prediction for 40 guests; then
the phases' cold and steady wall clock and the pipeline's counters.

Run:  python -m sparkdq4ml_tpu_torch.app [path/to/dataset.csv] [--device cpu]

It runs on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import sparkdq4ml_tpu_torch as dq
from sparkdq4ml_tpu_torch.models import LinearRegression, Vectors, VectorAssembler
from sparkdq4ml_tpu_torch.utils import PhaseTimer, configure_logging


def start(filename: str, device: Optional[str] = None) -> None:
    timer = PhaseTimer()

    # Session init (`App.java:38-41`)
    builder = dq.TorchSession.builder().app_name("DQ4ML").master("local[*]")
    if device is not None:
        builder = builder.config("spark.torch.device", device)
    spark = builder.get_or_create()

    # DQ Section (`App.java:44-95`)
    # ----------
    spark.udf.register("minimumPriceRule", dq.minimum_price_rule, "double")
    spark.udf.register("priceCorrelationRule", dq.price_correlation_rule, "double")

    def load_phase():
        return (spark.read.format("csv")
                .option("inferSchema", "true").option("header", "false")
                .load(filename))

    with timer.phase("load"):
        df = load_phase()

    df = df.with_column_renamed("_c0", "guest")
    df = df.with_column_renamed("_c1", "price")

    print("----")
    print("Load & Format")
    df.show()
    print("----")

    def dq_phase(d, show=False):
        d = d.with_column("price_no_min",
                          dq.call_udf("minimumPriceRule", d.col("price")))
        if show:
            print("----")
            print("1st DQ rule")
            d.print_schema()
            d.show(50)
            print("----")

        d.create_or_replace_temp_view("price")
        d = spark.sql("SELECT cast(guest as int) guest, price_no_min AS price "
                      "FROM price WHERE price_no_min > 0")
        if show:
            print("----")
            print("1st DQ rule - clean-up")
            d.print_schema()
            d.show(50)
            print("----")

        d = d.with_column("price_correct_correl",
                          dq.call_udf("priceCorrelationRule",
                                      d.col("price"), d.col("guest")))
        d.create_or_replace_temp_view("price")
        return spark.sql("SELECT guest, price_correct_correl AS price "
                         "FROM price WHERE price_correct_correl > 0")

    df_loaded = df
    with timer.phase("dq_rules"):
        df = dq_phase(df_loaded, show=True)

    print("----")
    print("2nd DQ rule")
    df.show(50)
    print("----")

    # ML Section (`App.java:98-126`)
    # ----------
    df = df.with_column("label", df.col("price"))

    assembler = VectorAssembler().setInputCols(["guest"]).setOutputCol("features")
    df = assembler.transform(df)
    df.print_schema()
    df.show()

    lr = LinearRegression().setMaxIter(40).setRegParam(1).setElasticNetParam(1)

    with timer.phase("fit"):
        model = lr.fit(df)

    # Steady-state re-runs (the cold numbers above include the kernels'
    # builds and the pipeline's first flushes). "fit" here is the full API
    # call: it materializes the model, so it includes device->host reads.
    timer.steady("load", load_phase, sync=lambda f: f.mask)
    timer.steady("dq_rules", lambda: dq_phase(df_loaded),
                 sync=lambda f: f.mask)
    timer.steady("fit", lambda: lr.fit(df))

    model.transform(df).show()

    # Summary (`App.java:132-146`)
    trainingSummary = model.summary
    print("numIterations: " + str(trainingSummary.totalIterations))
    print("objectiveHistory: [" +
          ",".join(str(v) for v in trainingSummary.objectiveHistory) + "]")
    trainingSummary.residuals.show()
    print("RMSE: " + str(trainingSummary.rootMeanSquaredError))
    print("r2: " + str(trainingSummary.r2))

    print("Intersection: " + str(model.intercept))
    print("Regression parameter: " + str(model.getRegParam()))
    print("Tol: " + str(model.getTol()))

    # Prediction (`App.java:148-154`)
    feature = 40.0
    features = Vectors.dense(40.0)
    p = model.predict(features)
    print(f"Prediction for {feature} guests is {p}")

    pairs = timer.report_pairs()
    # the JAX example's label, kept as it is so both reports read alike
    print("phase wall-clock (s, cold = first run incl. XLA compile):",
          {k: {m: (round(v, 4) if v is not None else None)
               for m, v in p.items()} for k, p in pairs.items()})

    # Pipeline-compiler telemetry: the steady reruns show `compile` frozen
    # while `flush`/`hit` climb, the cache reused across the repeated DQ
    # queries.
    from sparkdq4ml_tpu_torch.utils.profiling import counters
    print("pipeline counters:", counters.snapshot("pipeline"))


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m sparkdq4ml_tpu_torch.app")
    ap.add_argument("csv", nargs="?", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "data",
        "dataset-abstract.csv"))
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    start(args.csv, args.device)


if __name__ == "__main__":
    configure_logging()
    main(sys.argv[1:])
