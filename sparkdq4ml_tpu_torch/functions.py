"""``org.apache.spark.sql.functions`` subset: column constructors, UDF
invocation, sort markers, aggregates and window functions."""

from .frame.aggregates import (avg, count, count_distinct, countDistinct,
                               first, last, max, mean, min, stddev,
                               stddev_pop, sum, sum_distinct, sumDistinct,
                               var_pop, variance)
from .frame.window import (cume_dist, dense_rank, first_value, lag,
                           last_value, lead, nth_value, ntile, percent_rank,
                           rank, row_number)
from .ops.expressions import Col, call_udf, col, lit


def asc(name: str):
    """``F.asc("x")``: an ascending sort marker."""
    return Col(name).asc()


def desc(name: str):
    """``F.desc("x")``: a descending sort marker."""
    return Col(name).desc()


__all__ = ["col", "lit", "call_udf", "asc", "desc", "count", "sum",
           "avg", "mean", "min", "max", "stddev", "variance", "stddev_pop",
           "var_pop", "first", "last", "count_distinct", "countDistinct",
           "sum_distinct", "sumDistinct", "row_number", "rank", "dense_rank",
           "percent_rank", "cume_dist", "ntile", "lag", "lead",
           "first_value", "last_value", "nth_value"]
