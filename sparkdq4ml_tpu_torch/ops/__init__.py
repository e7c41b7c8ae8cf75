"""Column expressions, UDFs, DQ rules and the hand-written kernels."""

from .expressions import Expr, call_udf, col, lit
from .rules import (dq_rules_fused, minimum_price_rule,
                    price_correlation_rule, register_builtin_rules)
from .udf import UDFRegistry, default_registry
