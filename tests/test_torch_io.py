"""JSON lines, Parquet and the writer of the port (``frame/jsonl.py``,
``frame/parquet.py``, ``frame/writer.py``) against the JAX package's on
the same seeded frames and files: the CSV writer's bytes equal the JAX
writer's; a file either package writes (CSV, JSON, Parquet) reads in the
other to the same columns; ``DataFrameWriter`` modes and errors; under
both float policies. Parquet needs ``pyarrow`` (``importorskip``).

Tolerance: names, dtypes, row counts, strings and bytes exact, floats bit
for bit.
"""

import json

import numpy as np
import pytest
import torch
from test_torch_grouped import assert_same, policy  # noqa: F401

from sparkdq4ml_tpu.frame import jsonl as jax_jsonl
from sparkdq4ml_tpu.frame import parquet as jax_parquet
from sparkdq4ml_tpu.frame import writer as jax_writer
from sparkdq4ml_tpu.frame.csv import read_csv as jax_read_csv
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.ops import expressions as JE
from sparkdq4ml_tpu_torch import TorchSession
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame import jsonl, parquet, writer
from sparkdq4ml_tpu_torch.frame.csv import read_csv
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import expressions as TE

TEXTS = np.asarray(["plain", "a,b", 'say "hi"', "two\nlines", "", None,
                    "cr\rhere", "é"], dtype=object)


def table(n=40, seed=0, strings=True):
    """A seeded table: int32 keys, floats with NaN, an int64 column,
    booleans and (optionally) awkward strings."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(10.0, 5.0, n), 3)
    v[rng.random(n) < 0.15] = np.nan
    cols = {"k": rng.integers(0, 5, n).astype(np.int32), "v": v,
            "big": rng.integers(-10**6, 10**6, n).astype(np.int64),
            "b": rng.random(n) < 0.5}
    if strings:
        cols["s"] = TEXTS[rng.integers(0, len(TEXTS), n)]
    return cols


def both(cols, masked=True):
    """The columns as a JAX frame and a port frame on the CPU, the rows
    with k == 2 masked out."""
    j, t = JFrame(dict(cols)), TFrame(dict(cols), device="cpu")
    if masked:
        j, t = j.filter(JE.col("k") != 2), t.filter(TE.col("k") != 2)
    return j, t


@pytest.mark.parametrize("header", [False, True])
@pytest.mark.parametrize("delimiter", [",", ";"])
def test_csv_writer_bytes_match(policy, tmp_path, header, delimiter):
    j, t = both(table(seed=1))
    jax_writer.write_csv(j, str(tmp_path / "j.csv"), header, delimiter)
    writer.write_csv(t, str(tmp_path / "t.csv"), header, delimiter)
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("strings", [False, True])
def test_csv_files_cross_both_ways(policy, tmp_path, strings):
    j, t = both(table(seed=2, strings=strings))
    j.write.option("header", "true").save(str(tmp_path / "j.csv"))
    t.write.option("header", "true").save(str(tmp_path / "t.csv"))
    for path in ("j.csv", "t.csv"):
        p = str(tmp_path / path)
        assert_same(read_csv(p, header=True, device="cpu"),
                    jax_read_csv(p, header=True), 0.0)


def test_empty_frame_writes_nothing(tmp_path):
    j = JFrame({"a": np.zeros(0)})
    t = TFrame({"a": np.zeros(0)}, device="cpu")
    jax_writer.write_csv(j, str(tmp_path / "j.csv"), header=False)
    writer.write_csv(t, str(tmp_path / "t.csv"), header=False)
    assert (tmp_path / "t.csv").read_bytes() == b"" == \
        (tmp_path / "j.csv").read_bytes()


JSON_LINES = [
    {"i": 1, "f": 1.5, "s": "a", "b": True, "n": None, "l": [1, 2],
     "o": {"x": 1}, "huge": 2**70},
    {"i": 2, "f": 2, "s": None, "b": False, "l": [], "huge": 3},
    {"i": -3, "f": None, "s": "c,\"d\"", "b": True, "n": 4, "o": None,
     "huge": 4, "late": "x"},
]


@pytest.mark.parametrize("multi_line", [False, True])
def test_read_json_matches(policy, tmp_path, multi_line):
    path = tmp_path / "r.json"
    if multi_line:
        path.write_text(json.dumps(JSON_LINES, indent=1))
    else:
        path.write_text("\n".join(json.dumps(r) for r in JSON_LINES)
                        + "\n\n")
    got = jsonl.read_json(str(path), multi_line=multi_line, device="cpu")
    want = jax_jsonl.read_json(str(path), multi_line=multi_line)
    assert got.columns == want.columns
    assert got.dtypes() == want.dtypes()
    dg, dw = got.to_pydict(), want.to_pydict()
    for c in want.columns:  # object cells (lists, dicts) by their repr
        assert repr(dg[c].tolist()) == repr(dw[c].tolist()), c


@pytest.mark.parametrize("bad", ['{"a": 1}\n[1, 2]\n', '{"a": 1}'])
def test_read_json_rejects_non_objects(tmp_path, bad):
    path = tmp_path / "bad.json"
    path.write_text(bad)
    multi = not bad.endswith("\n")
    for read in (jax_jsonl.read_json, jsonl.read_json):
        with pytest.raises(ValueError):
            read(str(path), multi_line=multi)


def test_json_writer_bytes_match_and_cross(policy, tmp_path):
    j, t = both(table(seed=3))
    jax_jsonl.write_json(j, str(tmp_path / "j.jsonl"))
    jsonl.write_json(t, str(tmp_path / "t.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    for path in ("j.jsonl", "t.jsonl"):
        p = str(tmp_path / path)
        assert_same(jsonl.read_json(p, device="cpu"),
                    jax_jsonl.read_json(p), 0.0)


@pytest.mark.parametrize("vector", [False, True])
def test_parquet_files_cross_both_ways(policy, tmp_path, vector):
    pytest.importorskip("pyarrow")
    cols = table(seed=4)
    if vector:
        cols["vec"] = np.random.default_rng(5).normal(size=(40, 3))
        del cols["s"]
    j, t = both(cols)
    jax_parquet.write_parquet(j, str(tmp_path / "j.parquet"))
    parquet.write_parquet(t, str(tmp_path / "t.parquet"))
    import pyarrow.parquet as pq

    tables = [pq.read_table(str(tmp_path / p)) for p in ("t.parquet",
                                                         "j.parquet")]
    assert tables[0].schema == tables[1].schema
    # by repr, where NaN equals NaN
    assert repr(tables[0].to_pydict()) == repr(tables[1].to_pydict())
    for path in ("j.parquet", "t.parquet"):
        p = str(tmp_path / path)
        got = parquet.read_parquet(p, device="cpu")
        want = jax_parquet.read_parquet(p)
        assert got.columns == want.columns and got.dtypes() == want.dtypes()
        dg, dw = got.to_pydict(), want.to_pydict()
        for c in want.columns:
            assert repr(dg[c].tolist()) == repr(dw[c].tolist()), c


def test_parquet_nulls_become_nan(tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    p = str(tmp_path / "n.parquet")
    pq.write_table(pa.table({"x": pa.array([1, None, 3], pa.int64()),
                             "s": pa.array(["a", None, "c"])}), p)
    with float_policy(torch.float64):
        got = parquet.read_parquet(p, device="cpu")
    assert_same(got, jax_parquet.read_parquet(p), 0.0)
    assert np.isnan(got.to_pydict()["x"][1])


def test_writer_modes_and_formats(tmp_path):
    pytest.importorskip("pyarrow")
    with float_policy(torch.float64):
        s = TorchSession.builder().config("spark.torch.device",
                                          "cpu").get_or_create()
        try:
            df = s.create_data_frame(table(seed=6, strings=False))
            for fmt in ("csv", "json", "parquet"):
                path = str(tmp_path / f"out.{fmt}")
                getattr(df.write, fmt)(path)
                with pytest.raises(FileExistsError):
                    df.write.format(fmt).save(path)
                df.write.format(fmt).mode("overwrite").save(path)
                opts = {"inferSchema": "true"} if fmt == "csv" else {}
                back = s.read.format(fmt).options(**opts).load(path)
                assert back.count() == df.count() and back.device.type == \
                    "cpu"
            with pytest.raises(ValueError, match="unsupported write mode"):
                df.write.mode("append")
            with pytest.raises(ValueError, match="unsupported format"):
                df.write.format("orc").save(str(tmp_path / "x"))
            df.write.option("header", "true").csv(
                str(tmp_path / "sub" / "plain.csv"))
            assert (tmp_path / "sub" / "plain.csv").read_text().startswith(
                "k,v,big,b\n")
        finally:
            s.stop()
