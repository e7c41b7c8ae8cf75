"""sparkdq4ml_tpu_torch: the PyTorch/CUDA port of sparkdq4ml_tpu, for one
NVIDIA H100. It covers the reference application's path (CSV ingest, the
DQ rule/UDF layer, the SQL subset, the Lasso LinearRegression) and model
selection and robust fits (CrossValidator, TrainValidationSplit, Huber,
weighted fits, OWL-QN, pipelines and their persistence) and the frame and
SQL engine of the SQL tour (grouped aggregation, sort, distinct, joins,
window functions, arithmetic, string and array columns, string keys,
explode, IN/LIKE/CASE, CTEs, uncorrelated subqueries, temp-view DDL;
``ops/segments.py``, ``ops/strings.py``, ``frame/aggregates.py``,
``frame/window.py``, ``sql/parser.py``), and the classification family
with its evaluators (``models/classification.py``: LogisticRegression,
LinearSVC, NaiveBayes, OneVsRest; ``models/evaluation.py``), and ingest
and IO (the native CSV tokenizer streamed into page-locked buffers and
copied to the card, ``frame/native_csv.py``; quoted fields, read modes
and schemas, JSON lines, Parquet, the writer, unpivot, applyInPandas and
mapInPandas), and the analytic half of the frame and SQL engine (the
order-valued, moment, two-column and collection aggregates, rollup, cube
and pivot, ``df.stat``, describe, summary, sample, the set operations,
qualified names and correlated EXISTS/IN; ``frame/stat.py``), with the
fused DQ chain, the packed Gramian, the masked Gramian and the
fixed-order segment sums as hand-written CUDA kernels
(``ops/kernels.py``). The JAX package ``sparkdq4ml_tpu`` is the reference
and is not imported here."""

from .config import config
from .frame import Frame, list_column, read_csv, read_json, read_parquet
from .ops import (call_udf, col, dq_rules_fused, lit, minimum_price_rule,
                  price_correlation_rule, register_builtin_rules)
from .session import TorchSession

__version__ = "0.1.0"
