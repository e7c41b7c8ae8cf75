"""Temp-view catalog, the SQL subset with EXPLAIN [ANALYZE], the
cost-based optimizer and adaptive execution."""

from .catalog import Catalog, default_catalog
from .parser import execute, parse
