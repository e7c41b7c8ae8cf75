"""``org.apache.spark.sql.functions`` subset: column constructors and UDF
invocation."""

from .ops.expressions import call_udf, col, lit

__all__ = ["col", "lit", "call_udf"]
