"""``org.apache.spark.sql.functions`` subset: column constructors, UDF
invocation, sort markers, CASE WHEN, ``isnull``, the string functions
``concat``, ``concat_ws`` and ``split``, the ``explode`` generators,
every aggregate of the JAX package and the window functions."""

from .frame.aggregates import (approx_count_distinct, approxCountDistinct,
                               avg, collect_list, collect_set, corr, count,
                               count_distinct, countDistinct, covar_pop,
                               covar_samp, first, kurtosis, last, max, mean,
                               median, min, mode, percentile_approx,
                               skewness, stddev, stddev_pop, sum,
                               sum_distinct, sumDistinct, var_pop, variance)
from .frame.window import (cume_dist, dense_rank, first_value, lag,
                           last_value, lead, nth_value, ntile, percent_rank,
                           rank, row_number)
from .ops.expressions import (Col, call_udf, col, concat, concat_ws,
                              explode, explode_outer, isnull, lit, split,
                              when)


def asc(name: str):
    """``F.asc("x")``: an ascending sort marker."""
    return Col(name).asc()


def desc(name: str):
    """``F.desc("x")``: a descending sort marker."""
    return Col(name).desc()


__all__ = ["col", "lit", "call_udf", "asc", "desc", "when", "isnull",
           "concat", "concat_ws", "split", "explode", "explode_outer",
           "count", "sum",
           "avg", "mean", "min", "max", "stddev", "variance", "stddev_pop",
           "var_pop", "first", "last", "count_distinct", "countDistinct",
           "sum_distinct", "sumDistinct", "approx_count_distinct",
           "approxCountDistinct", "median", "mode", "percentile_approx",
           "collect_list", "collect_set", "skewness", "kurtosis", "corr",
           "covar_samp", "covar_pop", "row_number", "rank", "dense_rank",
           "percent_rank", "cume_dist", "ntile", "lag", "lead",
           "first_value", "last_value", "nth_value"]
