"""The port's native CSV engine (``frame/native_csv.py``, over the library
the port builds from ``native/csvparse.cpp``) against the JAX package's
``native_csv`` on the same seeded files: the one-shot read, the streamed
read forced by a small ``ingest_chunk_bytes`` (the bind body, with and
without the prefetch thread), headers, bare-CR records, empty fields,
exponent forms, a column that turns float in a later chunk (the
backfill), a quoted file (the per-chunk body), non-numeric content
declined to the Python engine under "auto", and ``engine="native"``
raising where the reference raises; then the build, the read record, the
producer's failure and the session's ``spark.ingest.*`` keys.

Tolerance: names, dtypes, row counts and values exact, floats bit for bit
(both packages parse with the same tokenizer), under both float policies.
"""

import math
import os

import numpy as np
import pytest
import torch
from test_torch_grouped import assert_same, policy  # noqa: F401

from conftest import dataset_path
from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.csv import read_csv as jax_read_csv
from sparkdq4ml_tpu_torch import TorchSession
from sparkdq4ml_tpu_torch.config import config, float_policy
from sparkdq4ml_tpu_torch.frame import native_csv
from sparkdq4ml_tpu_torch.frame.csv import read_csv
from sparkdq4ml_tpu_torch.ops.kernels import BUILD_ROOT
from test_torch_sql_core import smoke

INGEST = ("ingest_streaming", "ingest_chunk_bytes", "ingest_prefetch",
          "ingest_threads", "ingest_simd")


@pytest.fixture
def ingest():
    """``ingest(**settings)`` sets the ingest settings of both packages
    alike; all are restored after the test."""
    saved = [{k: getattr(c, k) for k in INGEST}
             for c in (config, jax_config)]

    def set_both(**settings):
        for k, v in settings.items():
            setattr(config, f"ingest_{k}", v)
            setattr(jax_config, f"ingest_{k}", v)

    yield set_both
    for c, old in zip((config, jax_config), saved):
        for k, v in old.items():
            setattr(c, k, v)


def both(path, **kwargs):
    """The file through the port (on the CPU) and the JAX package, with
    the same options; the port's frame, the JAX frame, the port's read
    record."""
    native_csv.reads.reset()
    got = read_csv(str(path), device="cpu", **kwargs)
    return got, jax_read_csv(str(path), **kwargs), native_csv.reads.last()


def check(path, **kwargs):
    got, want, rec = both(path, **kwargs)
    assert_same(got, want, 0.0)
    return got, rec


def seeded_lines(n, seed, late_float_at=None):
    """Rows of (int, two-decimal price, int that turns float at row
    ``late_float_at``)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-5, 40, n)
    p = np.round(rng.normal(100.0, 30.0, n), 2)
    k = rng.integers(0, 1000, n)
    lines = []
    for i in range(n):
        third = f"{k[i]}.5" if late_float_at is not None and \
            i >= late_float_at else f"{k[i]}"
        lines.append(f"{g[i]},{p[i]},{third}")
    return lines


@pytest.mark.parametrize("name", ["abstract", "small", "full"])
def test_reference_datasets_one_shot(policy, name):
    got, rec = check(dataset_path(name), header=False, infer_schema=True)
    assert got.dtypes() == [("_c0", "integer"),
                            ("_c1", "float" if config.default_float_dtype
                             == torch.float32 else "double")]
    assert rec["engine"] == "native" and rec["mode"] == "oneshot"


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("header", [False, True])
def test_streamed_read_matches(policy, ingest, tmp_path, prefetch, header):
    ingest(chunk_bytes=4096, prefetch=prefetch)
    lines = seeded_lines(3000, seed=1)
    if header:
        lines = ["guest,price,k"] + lines
    path = tmp_path / "s.csv"
    path.write_text("\n".join(lines) + "\n")
    got, rec = check(path, header=header, infer_schema=True)
    assert rec["mode"] == "pinned" and rec["rows"] == 3000
    assert rec["chunks"] >= math.ceil(os.path.getsize(path) / 4096) - 1
    assert got.columns == (["guest", "price", "k"] if header
                           else ["_c0", "_c1", "_c2"])


@pytest.mark.parametrize("streaming", [False, True])
def test_streaming_off_and_one_chunk_agree(ingest, tmp_path, streaming):
    ingest(chunk_bytes=2048, streaming=streaming)
    path = tmp_path / "s.csv"
    path.write_text("\n".join(seeded_lines(800, seed=2)) + "\n")
    with float_policy(torch.float64):
        got, rec = check(path, header=False, infer_schema=True)
    assert rec["mode"] == ("pinned" if streaming else "oneshot")


@pytest.mark.parametrize("chunk_bytes", [64, 8 << 20])
def test_bare_cr_records(ingest, tmp_path, chunk_bytes):
    ingest(chunk_bytes=chunk_bytes)
    path = tmp_path / "cr.csv"
    path.write_bytes(b"1,2.5\r3,4.5\r\r5,6.25\r" * 20)
    with float_policy(torch.float64):
        got, rec = check(path, header=False, infer_schema=True)
    assert got.collect()[:3] == [(1, 2.5), (3, 4.5), (5, 6.25)]
    assert rec["engine"] == "native"


@pytest.mark.parametrize("chunk_bytes", [32, 8 << 20])
def test_empty_fields_are_nan_and_promote_int(policy, ingest, tmp_path,
                                              chunk_bytes):
    ingest(chunk_bytes=chunk_bytes)
    path = tmp_path / "n.csv"
    path.write_bytes(b"1,2\n,3\n4,  \n5,6\n" * 8)
    got, rec = check(path, header=False, infer_schema=True)
    d = got.to_pydict()
    assert np.isnan(d["_c0"][1]) and np.isnan(d["_c1"][2])
    assert dict(got.dtypes())["_c0"] in ("double", "float")
    assert rec["engine"] == "native"


def test_exponent_sign_and_fuzzed_floats(tmp_path):
    rng = np.random.default_rng(99)
    vals = np.concatenate([
        rng.uniform(-1e3, 1e3, 200),
        rng.uniform(-1, 1, 200) * 10.0 ** rng.integers(-30, 30, 200),
        [0.0, -0.0, 1e-300, 1e308, 123456789012345678.0, 0.1, 1e22, 1e23]])
    lines = [repr(float(v)) for v in vals] + [f"{v:.20f}" for v in vals[:50]]
    lines += ["1e3", "+2.5", "-0.125", "3E-2", "0001.5000", ".5", "5.",
              "1e+0"]
    path = tmp_path / "forms.csv"
    path.write_text("\n".join(lines) + "\n")
    with float_policy(torch.float64):
        got, rec = check(path, header=False, infer_schema=True)
        python = read_csv(str(path), engine="python", device="cpu")
    assert rec["engine"] == "native"
    a = got.to_pydict()["_c0"]
    np.testing.assert_array_equal(a.view(np.int64),
                                  python.to_pydict()["_c0"].view(np.int64))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_column_turning_float_in_a_later_chunk(policy, ingest, tmp_path,
                                               prefetch):
    """The native backfill completes the float lane of rows parsed while
    the column still looked integral; the port copies none of them
    before."""
    ingest(chunk_bytes=2048, prefetch=prefetch)
    path = tmp_path / "late.csv"
    path.write_text("\n".join(seeded_lines(2000, seed=3,
                                           late_float_at=1700)) + "\n")
    got, rec = check(path, header=False, infer_schema=True)
    assert rec["mode"] == "pinned" and rec["chunks"] > 10
    assert [t for _, t in got.dtypes()][0] == "integer"
    assert got.dtypes()[2][1] in ("double", "float")


@pytest.mark.parametrize("chunk_bytes", [1024, 8 << 20])
def test_quoted_file(policy, ingest, tmp_path, chunk_bytes):
    ingest(chunk_bytes=chunk_bytes)
    lines = [",".join(f'"{f}"' for f in line.split(","))
             for line in seeded_lines(600, seed=4)]
    lines[5] = '"1","2.5",""'
    path = tmp_path / "q.csv"
    path.write_text('"a","b","c"\n' + "\n".join(lines) + "\n")
    got, rec = check(path, header=True, infer_schema=True)
    assert got.columns == ["a", "b", "c"]
    assert rec["engine"] == "native"
    assert rec["mode"] == ("chunked" if chunk_bytes == 1024 else "oneshot")


@pytest.mark.parametrize("body", [b"a,1\nb,2\n", b"1,2\n3,x\n",
                                  b"1,2\n1,2,3\n"])
def test_declined_to_python_under_auto(policy, tmp_path, body):
    path = tmp_path / "s.csv"
    path.write_bytes(body)
    got, rec = check(path, header=False, infer_schema=True, engine="auto")
    assert rec["engine"] == "python" and rec["declined"]
    assert native_csv.reads.snapshot()["counters"][
        "ingest.python_fallback"] == 1


def test_declined_mid_stream(ingest, tmp_path):
    ingest(chunk_bytes=512)
    lines = seeded_lines(400, seed=5)
    lines[350] = "1,x,3"
    path = tmp_path / "late_text.csv"
    path.write_text("\n".join(lines) + "\n")
    with float_policy(torch.float64):
        got, rec = check(path, header=False, infer_schema=True)
    assert rec["engine"] == "python" and rec["declined"]
    assert dict(got.dtypes())["_c1"] == "string"


@pytest.mark.parametrize("kwargs,match", [
    ({"mode": "DROPMALFORMED"}, "PERMISSIVE"),
    ({"mode": "FAILFAST"}, "PERMISSIVE"),
    ({"infer_schema": False}, "infer_schema"),
])
def test_native_engine_raises_where_the_reference_raises(tmp_path, kwargs,
                                                         match):
    path = tmp_path / "r.csv"
    path.write_bytes(b"1,2\n3,4\n")
    with pytest.raises(RuntimeError, match=match):
        jax_read_csv(str(path), engine="native", **kwargs)
    with pytest.raises(RuntimeError, match=match):
        read_csv(str(path), engine="native", device="cpu", **kwargs)


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_csv(str(tmp_path / "absent.csv"), device="cpu")


def test_header_wider_than_body_takes_python(tmp_path):
    path = tmp_path / "h.csv"
    path.write_bytes(b"a,b,c\n1,2\n3,4\n")
    with float_policy(torch.float64):
        got, rec = check(path, header=True, infer_schema=True)
    assert rec["engine"] == "python"


def test_build_lands_in_the_build_directory():
    path = native_csv.build()
    assert path.name == "libdqcsv.so" and path.parent.parent == BUILD_ROOT
    assert path == native_csv.build()
    assert native_csv.available() and native_csv.streaming_available()
    assert native_csv.simd_level() in ("scalar", "avx2", "avx512")
    assert native_csv.simd_level("off") == "scalar"
    flags = native_csv.CXX_FLAGS
    assert native_csv.build_key(flags, "a") != native_csv.build_key(flags,
                                                                    "b")
    assert native_csv.build_key(flags, "a") != native_csv.build_key(
        flags + ("-g",), "a")


def test_cpu_columns_alias_and_never_pool(ingest, tmp_path):
    """On the CPU the columns are views of the bind buffers, so those
    buffers never return to the pool (the reference's alias rule)."""
    ingest(chunk_bytes=1024)
    path = tmp_path / "s.csv"
    path.write_text("\n".join(seeded_lines(500, seed=6)) + "\n")
    before = len(native_csv._POOL)
    with float_policy(torch.float64):
        a = read_csv(str(path), device="cpu")
        b = read_csv(str(path), device="cpu")
    assert len(native_csv._POOL) == before
    assert a._data["_c1"].data_ptr() != b._data["_c1"].data_ptr()
    assert_same(a, b, 0.0)


def test_read_record_counters(ingest, tmp_path):
    ingest(chunk_bytes=1024)
    path = tmp_path / "s.csv"
    path.write_text("\n".join(seeded_lines(500, seed=7)) + "\n")
    native_csv.reads.reset()
    with float_policy(torch.float64):
        read_csv(str(path), device="cpu")
        read_csv(dataset_path("abstract"), device="cpu")
    snap = native_csv.reads.snapshot()
    c = snap["counters"]
    assert set(c) == set(native_csv.COUNTERS)
    assert c["ingest.files"] == 2 and c["ingest.streamed"] == 1
    assert c["ingest.rows"] == 540
    assert c["ingest.bytes"] == os.path.getsize(path) + os.path.getsize(
        dataset_path("abstract"))
    assert [r["mode"] for r in snap["reads"]] == ["pinned", "oneshot"]
    assert c["ingest.chunks"] == snap["reads"][0]["chunks"] + 1


def test_dead_producer_raises(ingest):
    def next_chunk():
        raise OSError("disk gone")

    ingest(prefetch=2)
    with pytest.raises(native_csv.NativeIngestError,
                       match="disk gone") as err:
        list(native_csv._prefetch_iter(next_chunk))
    assert isinstance(err.value.__cause__, OSError)


def test_prefetch_releases_unconsumed_chunks(ingest):
    """Closing the iterator joins the producer; every chunk it parsed was
    consumed or released."""
    import threading

    produced, released = [], []

    def next_chunk():
        produced.append(len(produced) + 1)
        return 1, produced[-1]

    ingest(prefetch=2)
    it = native_csv._prefetch_iter(next_chunk, release=released.append)
    assert next(it) == (1, 1)
    it.close()
    assert not any(t.name == "dqcsv-prefetch" for t in threading.enumerate())
    assert sorted([1] + released) == produced


def test_concurrent_reads_keep_their_columns_and_the_record(ingest,
                                                           tmp_path):
    """Sixteen threads stream their own files at once (a short switch
    interval): each frame equals its file's one-shot read, and the record
    counts every read."""
    import sys
    import threading

    ingest(chunk_bytes=1024, prefetch=2)
    paths = []
    for i in range(16):
        path = tmp_path / f"s{i}.csv"
        path.write_text("\n".join(seeded_lines(300, seed=100 + i)) + "\n")
        paths.append(str(path))
    got = [None] * len(paths)
    errors = []
    native_csv.reads.reset()

    def read(i):
        try:
            got[i] = read_csv(paths[i], device="cpu")
        except BaseException as e:  # reported below
            errors.append(e)

    # the float policy is process-wide: set once, around all the threads
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with float_policy(torch.float64):
            threads = [threading.Thread(target=read, args=(i,))
                       for i in range(len(paths))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    counters = native_csv.reads.snapshot()["counters"]
    assert counters["ingest.files"] == counters["ingest.streamed"] == 16
    assert counters["ingest.rows"] == 16 * 300
    ingest(streaming=False)
    with float_policy(torch.float64):
        for frame, path in zip(got, paths):
            assert_same(frame, read_csv(path, device="cpu"), 0.0)


def test_session_ingest_keys_set_and_restore(tmp_path):
    old = (config.ingest_streaming, config.ingest_chunk_bytes,
           config.ingest_prefetch, config.ingest_threads, config.ingest_simd)
    s = (TorchSession.builder().config("spark.torch.device", "cpu")
         .config("spark.ingest.streaming", "false")
         .config("spark.ingest.chunkBytes", 1024)
         .config("spark.ingest.prefetch", 0)
         .config("spark.ingest.threads", 2)
         .config("spark.ingest.simd", "OFF").get_or_create())
    try:
        assert (config.ingest_streaming, config.ingest_chunk_bytes,
                config.ingest_prefetch, config.ingest_threads,
                config.ingest_simd) == (False, 1024, 0, 2, "off")
        TorchSession.builder().config("spark.ingest.streaming",
                                      "true").get_or_create()
        assert config.ingest_streaming is True
        path = tmp_path / "s.csv"
        path.write_text("\n".join(seeded_lines(300, seed=8)) + "\n")
        with float_policy(torch.float64):
            df = s.read.format("csv").option("inferSchema", "true").load(
                str(path))
        rec = native_csv.reads.last()
        assert rec["mode"] == "pinned" and rec["prefetch"] == 0
        assert rec["simd"] == "scalar" and rec["threads"] == 2
        assert df.device.type == "cpu" and df.count() == 300
    finally:
        s.stop()
    assert (config.ingest_streaming, config.ingest_chunk_bytes,
            config.ingest_prefetch, config.ingest_threads,
            config.ingest_simd) == old


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("quoted", [False, True])
def test_chip_smoke_ingest_file_reads_back(ingest, tmp_path, quoted, dtype):
    """The chip script's phase-10 file (``write_table_csv``) at 20,000
    rows, plain and with every field quoted, streamed in many chunks (the
    bind body, or the per-chunk body for the quoted file): bit for bit the
    columns it was written from, and its one-shot read."""
    guest, price = smoke.full_table(20_000)
    path = str(tmp_path / "t.csv")
    size = smoke.write_table_csv(path, guest, price, quoted=quoted)
    ingest(chunk_bytes=4096)
    with float_policy(dtype):
        got = read_csv(path, header=False, infer_schema=True, device="cpu")
        rec = native_csv.reads.last()
        ingest(streaming=False)
        one = read_csv(path, header=False, infer_schema=True, device="cpu")
    assert rec["mode"] == ("chunked" if quoted else "pinned")
    assert rec["chunks"] >= math.ceil(size / 4096)
    assert native_csv.reads.last()["mode"] == "oneshot"
    assert_same(got, one, 0.0)
    g, p = got._column_values("_c0"), got._column_values("_c1")
    assert g.dtype == torch.int32 and p.dtype == dtype
    assert np.array_equal(g.numpy(), guest)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    assert np.array_equal(p.numpy().view(np.uint8),
                          price.astype(np_dt).view(np.uint8))
