"""Columnar frame, CSV ingest (the native tokenizer and the Python
engine), JSON lines, Parquet and the writer."""

from .csv import DataFrameReader, read_csv
from .frame import Frame
from .jsonl import read_json, write_json
from .parquet import read_parquet, write_parquet
from .writer import DataFrameWriter, write_csv
