"""Columnar frame and CSV ingest."""

from .csv import DataFrameReader, read_csv
from .frame import Frame
