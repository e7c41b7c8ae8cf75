"""Temp-view catalog and the SQL subset."""

from .catalog import Catalog, default_catalog
from .parser import execute, parse
