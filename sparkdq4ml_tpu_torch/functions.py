"""``org.apache.spark.sql.functions``: every name that
``sparkdq4ml_tpu/functions.py`` exports (column constructors, UDF
invocation, CASE WHEN, the builtin scalar functions, the generators, the
higher-order functions, ``expr``, every aggregate and the window
functions), plus the sort markers ``asc``/``desc``."""

from .frame.aggregates import (approx_count_distinct, approxCountDistinct,
                               avg, collect_list, collect_set, corr, count,
                               count_distinct, countDistinct, covar_pop,
                               covar_samp, first, kurtosis, last, max, mean,
                               median, min, mode, percentile_approx,
                               skewness, stddev, stddev_pop, sum,
                               sum_distinct, sumDistinct, var_pop, variance)
from .frame.window import (Window, WindowSpec, cume_dist, dense_rank,
                           first_value, lag, last_value, lead, nth_value,
                           ntile, percent_rank, rank, row_number)
from .ops.expressions import (Col, Lambda, acos, add_months, aggregate,
                              array, array_contains, array_distinct,
                              array_except, array_intersect, array_join,
                              array_max, array_min, array_position,
                              array_remove, array_repeat, array_union,
                              arrays_overlap, arrays_zip, ascii, asin, atan,
                              atan2, base64, bin, bit_length, bitwiseNOT,
                              bround, call_udf, callUDF, cbrt, ceil,
                              coalesce, col, concat, concat_ws, conv, cos,
                              cosh, crc32, current_date, current_timestamp,
                              date_add, date_format, date_sub, date_trunc,
                              datediff, dayofmonth, dayofweek, dayofyear,
                              decode, degrees, element_at, encode, exists,
                              exp, explode, explode_outer, expm1, expr,
                              factorial, filter, flatten, floor,
                              format_number, format_string, fn,
                              from_unixtime, get_json_object, greatest,
                              hash, hex, hour, hypot, ifnull, initcap,
                              instr, isnan, isnull, json_tuple, last_day,
                              least, length, levenshtein, lit, locate, log,
                              log1p, log2, log10, lower, lpad, ltrim, md5,
                              minute, monotonically_increasing_id, month,
                              months_between, nanvl, next_day, nullif, nvl,
                              nvl2, octet_length, posexplode, pow, quarter,
                              radians, rand, randn, regexp_extract,
                              regexp_replace, repeat, reverse, rint, rpad,
                              rtrim, second, sequence, sha1, sha2,
                              shiftleft, shiftright, shiftrightunsigned,
                              shuffle, signum, sin, sinh, size, slice,
                              sort_array, soundex, spark_partition_id,
                              split, sqrt, substring, substring_index, tan,
                              tanh, to_date, to_timestamp, transform,
                              translate, trim, trunc, unbase64, unhex,
                              unix_timestamp, upper, weekofyear, when,
                              xxhash64, year)
from .ops.expressions import sql_abs as abs  # noqa: A001 - Spark name
from .ops.expressions import sql_round as round  # noqa: A001 - Spark name


def asc(name: str):
    """``F.asc("x")``: an ascending sort marker."""
    return Col(name).asc()


def desc(name: str):
    """``F.desc("x")``: a descending sort marker."""
    return Col(name).desc()


def broadcast(df):
    """Spark's ``broadcast(df)`` join hint: a no-op, the join plans
    itself."""
    return df


__all__ = ["col", "lit", "call_udf", "callUDF", "asc", "desc", "count",
           "sum", "avg", "mean", "min", "max", "stddev", "variance",
           "count_distinct", "countDistinct", "approx_count_distinct",
           "approxCountDistinct", "sum_distinct", "sumDistinct",
           "collect_list", "collect_set", "first", "last",
           "skewness", "kurtosis", "corr", "covar_samp", "covar_pop",
           "abs", "sqrt", "exp", "log", "log10", "pow", "floor", "ceil",
           "round", "signum", "greatest", "least", "isnan", "isnull",
           "coalesce", "nvl", "when", "fn", "md5", "sha1", "sha2", "base64",
           "unbase64", "median", "mode", "percentile_approx", "stddev_pop",
           "var_pop", "array_contains", "element_at", "size", "explode",
           "explode_outer", "posexplode",
           "upper", "lower", "trim", "ltrim", "rtrim", "length", "concat",
           "substring",
           "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
           "sinh", "cosh", "tanh", "degrees", "radians", "cbrt",
           "expm1", "log1p", "log2", "hypot", "rint",
           "concat_ws", "split", "regexp_replace", "regexp_extract",
           "instr", "locate", "lpad", "rpad", "repeat", "reverse",
           "initcap", "translate",
           "to_date", "unix_timestamp", "from_unixtime", "date_format",
           "datediff", "date_add", "date_sub", "current_date",
           "year", "month", "dayofmonth", "dayofweek", "dayofyear",
           "quarter",
           "Window", "WindowSpec", "row_number", "rank", "dense_rank",
           "percent_rank", "cume_dist", "ntile", "lag", "lead",
           "first_value", "last_value", "nth_value",
           "array", "sort_array", "array_distinct", "array_join", "slice",
           "flatten", "nanvl", "format_number", "format_string",
           "levenshtein", "rand", "randn", "monotonically_increasing_id",
           "spark_partition_id", "expr", "broadcast",
           "array_position", "array_remove", "array_union",
           "array_intersect", "array_except", "arrays_overlap",
           "array_min", "array_max", "array_repeat", "sequence",
           "arrays_zip", "shuffle",
           "hour", "minute", "second", "weekofyear", "last_day",
           "add_months", "months_between", "next_day", "trunc",
           "date_trunc", "to_timestamp", "current_timestamp",
           "bround", "factorial", "hex", "unhex", "bin", "conv",
           "ascii", "crc32", "hash", "xxhash64", "shiftleft",
           "shiftright", "shiftrightunsigned", "bitwiseNOT", "nullif",
           "nvl2", "ifnull", "substring_index", "soundex", "encode",
           "decode", "bit_length", "octet_length", "get_json_object",
           "json_tuple",
           "transform", "filter", "exists", "aggregate", "Lambda"]
