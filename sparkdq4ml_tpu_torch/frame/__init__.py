"""Columnar frame (with ``df.stat``), CSV ingest (the native tokenizer and
the Python engine), JSON lines, Parquet and the writer."""

from .csv import DataFrameReader, read_csv
from .frame import Frame, list_column
from .jsonl import read_json, write_json
from .parquet import read_parquet, write_parquet
from .stat import FrameStatFunctions
from .writer import DataFrameWriter, write_csv
