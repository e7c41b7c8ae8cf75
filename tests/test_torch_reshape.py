"""Reshapes, pandas interop and the session's table surface of the port
against the JAX package on the same seeded frames: ``unpivot``/``melt``,
``to_pandas``, ``groupBy().applyInPandas``, ``mapInPandas``,
``spark.table``, ``spark.range`` and ``spark.version``; then every section
of ``examples/io_tour.py`` (CSV, Parquet and JSON round trips, unpivot,
applyInPandas, mapInPandas, spark.table) through ``TorchSession`` and
``TpuSession``, under both float policies.

Tolerance: names, dtypes, row order, strings and values exact, floats bit
for bit, but for the per-group means of the tour's applyInPandas, which
the two grouped engines sum in their own orders: rtol 1e-9 under float64
and 1e-5 under float32 (``test_torch_grouped.RTOL``).
"""

import os
import shutil

import numpy as np
import pytest
from test_torch_grouped import assert_same, policy  # noqa: F401

pd = pytest.importorskip("pandas")

import sparkdq4ml_tpu as jdq  # noqa: E402
import sparkdq4ml_tpu_torch as tdq  # noqa: E402
from conftest import DATA_DIR  # noqa: E402
from sparkdq4ml_tpu import functions as JF  # noqa: E402
from sparkdq4ml_tpu.frame.frame import Frame as JFrame  # noqa: E402
from sparkdq4ml_tpu.ops import expressions as JE  # noqa: E402
from sparkdq4ml_tpu_torch import functions as TF  # noqa: E402
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame  # noqa: E402
from sparkdq4ml_tpu_torch.ops import expressions as TE  # noqa: E402
from sparkdq4ml_tpu_torch.sql import default_catalog  # noqa: E402


def table(n=30, seed=0):
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(10.0, 5.0, n), 2)
    v[rng.random(n) < 0.1] = np.nan
    name = np.asarray(rng.choice(["ann", "bo", "cy", None], n),
                      dtype=object)
    return {"g": rng.integers(0, 4, n).astype(np.int32), "v": v,
            "w": rng.normal(size=n).astype(np.float32),
            "i": rng.integers(-50, 50, n).astype(np.int64),
            "flag": rng.random(n) < 0.5, "name": name}


def both(cols=None, keep=True):
    cols = table() if cols is None else cols
    j, t = JFrame(dict(cols)), TFrame(dict(cols), device="cpu")
    if keep:
        j, t = j.filter(JE.col("g") != 1), t.filter(TE.col("g") != 1)
    return j, t


@pytest.fixture
def port_session():
    s = (tdq.TorchSession.builder().app_name("test")
         .config("spark.torch.device", "cpu").get_or_create())
    yield s
    s.stop()
    default_catalog().clear()


UNPIVOTS = {
    "one_id": lambda f: f.unpivot("g", ["v", "w"], "metric", "amount"),
    "ids_default_values": lambda f: f.select("g", "i", "v", "flag")
    .unpivot(["g", "i"]),
    "string_id": lambda f: f.unpivot(["name"], ["i", "flag"]),
    "single_value": lambda f: f.melt("name", "w"),
    "empty": lambda f: f.filter(f.col("g") > 9).unpivot("g", ["v"]),
}


@pytest.mark.parametrize("case", sorted(UNPIVOTS))
def test_unpivot_matches(policy, case):
    j, t = both()
    assert_same(UNPIVOTS[case](t), UNPIVOTS[case](j), 0.0)


def test_unpivot_rejects_bad_columns():
    j, t = both()
    for f in (j, t):
        with pytest.raises(ValueError, match="not a column"):
            f.unpivot("g", ["nope"])
        with pytest.raises(ValueError, match="at least one"):
            f.unpivot("g", [])


def test_to_pandas_matches(policy):
    j, t = both()
    pd.testing.assert_frame_equal(t.to_pandas(), j.to_pandas())
    assert list(t.toPandas().columns) == t.columns


def test_to_pandas_vector_column():
    cols = {"x": np.arange(4.0), "vec": np.arange(12.0).reshape(4, 3)}
    j, t = JFrame(cols), TFrame(cols, device="cpu")
    a, b = t.to_pandas(), j.to_pandas()
    assert a["vec"].dtype == object == b["vec"].dtype
    assert [list(r) for r in a["vec"]] == [list(r) for r in b["vec"]]


def demean(g):
    g = g.copy()
    g["v"] = g["v"] - g["v"].mean()
    return g


APPLY = {
    "demean": (["g"], demean, "g INT, v DOUBLE"),
    "string_key_count": (["name"], lambda g: pd.DataFrame(
        {"name": g["name"].iloc[:1], "n": [len(g)]}), "name STRING, n INT"),
    "two_keys": (["g", "flag"], lambda g: g[["g", "flag", "i"]].head(2),
                 "g DOUBLE, flag INT, i INT"),
}


@pytest.mark.parametrize("case", sorted(APPLY))
def test_apply_in_pandas_matches(policy, case):
    keys, fn, schema = APPLY[case]
    j, t = both()
    assert_same(t.group_by(*keys).applyInPandas(fn, schema),
                j.group_by(*keys).applyInPandas(fn, schema), 0.0)


def test_apply_in_pandas_errors_and_empty(policy):
    j, t = both()
    for f in (j, t):
        with pytest.raises(TypeError, match="applyInPandas"):
            f.group_by("g").apply_in_pandas(lambda g: 1, "g INT")
        with pytest.raises(ValueError, match="missing schema columns"):
            f.group_by("g").apply_in_pandas(lambda g: g, "zz DOUBLE")
    empty = (t.filter(TE.col("g") > 9).group_by("g")
             .apply_in_pandas(demean, "g INT, v DOUBLE"))
    want = (j.filter(JE.col("g") > 9).group_by("g")
            .apply_in_pandas(demean, "g INT, v DOUBLE"))
    assert_same(empty, want, 0.0)


def ratio(batches):
    for b in batches:
        b = b.copy()
        b["r"] = b["v"] / b["g"]
        yield b


@pytest.mark.parametrize("schema", ["g INT, v DOUBLE, r DOUBLE",
                                    "r FLOAT, name STRING"])
def test_map_in_pandas_matches(policy, schema):
    j, t = both()
    assert_same(t.mapInPandas(ratio, schema), j.mapInPandas(ratio, schema),
                0.0)


def test_map_in_pandas_errors():
    j, t = both()
    for f in (j, t):
        with pytest.raises(TypeError, match="mapInPandas"):
            f.map_in_pandas(lambda it: iter([1]), "g INT")
        with pytest.raises(ValueError, match="missing schema columns"):
            f.map_in_pandas(ratio, "zz DOUBLE")


RANGES = [(5,), (2, 11, 3), (10, 0, -2), (0,), (3, 3)]


@pytest.mark.parametrize("args", RANGES)
def test_range_matches(policy, session, port_session, args):
    assert_same(port_session.range(*args), session.range(*args), 0.0)


def test_range_limits(policy, session, port_session):
    for s in (session, port_session):
        with pytest.raises(ValueError, match="step"):
            s.range(0, 5, 0)
    big = (2 ** 31 - 2, 2 ** 31 + 1)
    if port_session.range(1).dtypes() == [("id", "long")]:
        assert_same(port_session.range(*big), session.range(*big), 0.0)
    else:
        for s in (session, port_session):
            with pytest.raises(ValueError, match="exceed int32"):
                s.range(*big)


def test_table_and_version(port_session):
    df = port_session.create_data_frame({"a": np.arange(3.0)})
    df.create_or_replace_temp_view("t1")
    assert port_session.table("t1") is df
    with pytest.raises(KeyError):
        port_session.table("absent")
    assert port_session.version == tdq.__version__


def io_tour(dq, F, spark, tmp):
    """Every section of ``examples/io_tour.py`` with its asserts, through
    one package's session; returns what each section produced."""
    out = {}
    df = (spark.read.format("csv").option("inferSchema", "true")
          .load(os.path.join(DATA_DIR, "dataset-full.csv"))
          .with_column_renamed("_c0", "guest")
          .with_column_renamed("_c1", "price"))
    n = df.count()
    assert n == 1040
    out["csv"] = df
    pq_path = os.path.join(tmp, "inv.parquet")
    df.write.parquet(pq_path)
    back = spark.read.parquet(pq_path)
    assert back.count() == n
    np.testing.assert_array_equal(
        np.sort(np.asarray(back.to_pydict()["price"], np.float64)),
        np.sort(np.asarray(df.to_pydict()["price"], np.float64)))
    out["parquet"] = back
    js_path = os.path.join(tmp, "inv.jsonl")
    df.limit(100).write.json(js_path)
    jback = spark.read.json(js_path)
    assert jback.count() == 100
    out["json"] = jback
    wide = df.limit(5).select("guest", "price") \
        .with_column("price2", dq.col("price") * 2)
    long = wide.unpivot("guest", ["price", "price2"], "metric", "amount")
    assert long.count() == 10
    assert list(long.to_pydict()["metric"][:2]) == ["price", "price2"]
    out["unpivot"] = long

    def demean_price(g):
        g = g.copy()
        g["price"] = g["price"] - g["price"].mean()
        return g

    demeaned = (df.group_by("guest")
                .apply_in_pandas(demean_price, "guest DOUBLE, price DOUBLE"))
    assert demeaned.count() == n
    out["demeaned"] = demeaned
    means = demeaned.group_by("guest").agg(F.avg("price").alias("m"))
    assert max(abs(float(m)) for m in means.to_pydict()["m"]) < 1e-3
    out["means"] = means

    def add_ratio(batches):
        for b in batches:
            b = b.copy()
            b["ratio"] = b["price"] / b["guest"]
            yield b

    with_ratio = df.map_in_pandas(
        add_ratio, "guest DOUBLE, price DOUBLE, ratio DOUBLE")
    assert with_ratio.columns == ["guest", "price", "ratio"]
    out["map_in_pandas"] = with_ratio
    df.create_or_replace_temp_view("inv")
    assert spark.table("inv").count() == n
    spark.catalog.drop("inv")
    return out


def test_io_tour_matches(policy, session, port_session, tmp_path):
    pytest.importorskip("pyarrow")
    rtol = policy
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = io_tour(jdq, JF, session, str(tmp_path / "j"))
    got = io_tour(tdq, TF, port_session, str(tmp_path / "t"))
    assert sorted(got) == sorted(want)
    for section in want:
        assert_same(got[section], want[section], rtol,
                    approx=("m",) if section == "means" else ())
    shutil.rmtree(tmp_path)
