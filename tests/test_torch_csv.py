"""The port's Python CSV engine (``frame/csv.py``) against the JAX
package's on the same files: quoted fields (delimiters, record separators
and doubled quotes inside quotes), quoted headers, blank records, each
read ``mode`` on ragged rows, explicit DDL schemas, ``inferSchema`` off,
the tokenizer functions themselves, and ``engine="auto"`` declining to
the Python engine for a mode or a schema; under both float policies.

Tolerance: names, dtypes, row counts, strings and values exact, floats
bit for bit (both packages parse with Python's ``float``).
"""

import numpy as np
import pytest
import torch
from test_torch_grouped import assert_same, policy  # noqa: F401

from sparkdq4ml_tpu.frame import csv as jax_csv
from sparkdq4ml_tpu_torch import TorchSession
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame import csv as port_csv
from sparkdq4ml_tpu_torch.frame import native_csv

QUOTED = (
    'id,name,score\n'
    '1,"Smith, Jo",3.5\n'
    '2,"He said ""hi""",4\n'
    '3,"two\nlines",\n'
    '\n'
    '4,"",5.25\r\n'
    '5,plain,-1e3\r'
    '6,"a\r\nb",7\n')


def both(path, **kwargs):
    native_csv.reads.reset()
    got = port_csv.read_csv(str(path), device="cpu", **kwargs)
    return got, jax_csv.read_csv(str(path), **kwargs), native_csv.reads.last()


def check(path, **kwargs):
    got, want, rec = both(path, **kwargs)
    assert_same(got, want, 0.0)
    return got, rec


@pytest.mark.parametrize("engine", ["python", "auto"])
def test_quoted_fields(policy, tmp_path, engine):
    path = tmp_path / "q.csv"
    path.write_text(QUOTED, newline="")
    got, rec = check(path, header=True, infer_schema=True, engine=engine)
    d = got.to_pydict()
    assert d["name"].tolist() == ["Smith, Jo", 'He said "hi"', "two\nlines",
                                  None, "plain", "a\r\nb"]
    assert rec["engine"] == "python"
    assert rec["declined"] == (engine == "auto")


@pytest.mark.parametrize("text", [
    'a,b\n1,2\n', '"a",b\n"1",2\n', 'x;"y;z"\n1;2\n', '\n\n  \n1,2\n',
    '"",x\n', 'a,"b\nc",d\n1,2,3', '"unterminated,1\n2,3\n'])
def test_tokenizer_functions_match(text):
    for delim in (",", ";"):
        assert port_csv.parse_csv_text(text, delim, '"') == \
            jax_csv.parse_csv_text(text, delim, '"')
    for rec in text.split("\n"):
        assert port_csv.split_fields(rec) == jax_csv.split_fields(rec)
    assert port_csv.split_records(text) == jax_csv.split_records(text)


RAGGED = "1,2.5,a\n2,3.5\n3,4.5,c,extra\n4,5.5,d\n"


@pytest.mark.parametrize("mode", ["PERMISSIVE", "DROPMALFORMED",
                                  "permissive", "dropmalformed"])
def test_read_modes(policy, tmp_path, mode):
    path = tmp_path / "r.csv"
    path.write_text(RAGGED)
    got, rec = check(path, header=False, infer_schema=True, mode=mode)
    assert got.count() == (4 if mode.upper() == "PERMISSIVE" else 2)
    # PERMISSIVE tries the native engine first, which declines the text
    assert rec["engine"] == "python"
    assert rec["declined"] == (mode.upper() == "PERMISSIVE")


def test_failfast_and_bad_mode_raise(tmp_path):
    path = tmp_path / "r.csv"
    path.write_text(RAGGED)
    for read in (jax_csv.read_csv, lambda *a, **k: port_csv.read_csv(
            *a, device="cpu", **k)):
        with pytest.raises(ValueError, match="FAILFAST"):
            read(str(path), mode="FAILFAST")
        with pytest.raises(ValueError, match="mode="):
            read(str(path), mode="LENIENT")


SCHEMA_FILE = ("1,2.5,x,true,10,1.25\n"
               "2,,y,false,11,2.5\n"
               "3,4.0,,true,12,3.75\n")


@pytest.mark.parametrize("ddl", [
    "a INT, b DOUBLE, s STRING, t BOOLEAN, l LONG, f FLOAT",
    "a integer, b double, s string, t string, l int, f double",
    "a DOUBLE, b INT, s STRING, t BOOLEAN, l DOUBLE, f INT",
    "a LONG, b LONG, s STRING, t STRING, l LONG, f LONG",
])
def test_ddl_schemas(policy, tmp_path, ddl):
    path = tmp_path / "s.csv"
    path.write_text(SCHEMA_FILE)
    fields = port_csv.parse_ddl_schema(ddl)
    assert fields == jax_csv.parse_ddl_schema(ddl)
    got, rec = check(path, schema=fields)
    assert got.columns == [n for n, _ in fields]
    assert rec["engine"] == "python"


def test_schema_through_the_reader(tmp_path):
    path = tmp_path / "s.csv"
    path.write_text("a,b\n1,2.5\n2,\n3,4.0\n")
    with float_policy(torch.float64):
        s = TorchSession.builder().config("spark.torch.device",
                                          "cpu").get_or_create()
        try:
            got = (s.read.schema("a LONG, b DOUBLE")
                   .option("engine", "native").csv(str(path), header=True))
        finally:
            s.stop()
    assert got.dtypes() == [("a", "long"), ("b", "double")]
    assert np.isnan(got.to_pydict()["b"][1])


@pytest.mark.parametrize("ddl,match", [
    ("a INT b DOUBLE", "bad DDL field"), ("a DECIMAL", "unknown SQL type"),
    ("a INT,", "bad DDL field")])
def test_bad_ddl_raises(ddl, match):
    for parse in (jax_csv.parse_ddl_schema, port_csv.parse_ddl_schema):
        with pytest.raises(ValueError, match=match):
            parse(ddl)


def test_schema_width_mismatch_raises(tmp_path):
    path = tmp_path / "s.csv"
    path.write_text(SCHEMA_FILE)
    schema = port_csv.parse_ddl_schema("a INT, b DOUBLE")
    with pytest.raises(ValueError, match="schema has 2 fields"):
        jax_csv.read_csv(str(path), schema=schema)
    with pytest.raises(ValueError, match="schema has 2 fields"):
        port_csv.read_csv(str(path), schema=schema, device="cpu")


@pytest.mark.parametrize("text", [
    "1,true,x\n2,false,y\n", "1,TRUE\n2,maybe\n", "3000000000,1\n4,2\n",
    "  ,1\n2,  \n", "1.5,2\n,3\n", "a,b\n,c\n"])
def test_inference(policy, tmp_path, text):
    path = tmp_path / "i.csv"
    path.write_text(text)
    check(path, header=False, infer_schema=True, engine="python")


def test_infer_schema_off_reads_strings(policy, tmp_path):
    path = tmp_path / "o.csv"
    path.write_text("h1,h2\n1,2.5\n,x\n")
    got, _ = check(path, header=True, infer_schema=False)
    assert got.dtypes() == [("h1", "string"), ("h2", "string")]


def test_empty_file(policy, tmp_path):
    path = tmp_path / "e.csv"
    path.write_text("")
    got, _ = check(path, header=False, infer_schema=True, engine="python")
    assert got.columns == [] and got.count() == 0


def test_reader_options_and_formats(tmp_path):
    path = tmp_path / "d.csv"
    path.write_text("x|y\n1|'a|b'\n")
    with float_policy(torch.float64):
        s = TorchSession.builder().config("spark.torch.device",
                                          "cpu").get_or_create()
        try:
            got = s.read.options(header="true", sep="|", quote="'",
                                 inferSchema="true").format("csv").load(
                str(path))
            with pytest.raises(ValueError, match="unsupported format"):
                s.read.format("orc").load(str(path))
            with pytest.raises(FileNotFoundError):
                s.read.csv(str(tmp_path / "absent.csv"))
        finally:
            s.stop()
    assert got.to_pydict()["y"].tolist() == ["a|b"]
