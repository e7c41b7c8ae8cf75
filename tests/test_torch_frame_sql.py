"""The torch port's CSV reader, frame and SQL subset held against the JAX
package's, in float64: ``read_csv`` gives equal names, dtypes and values on
the three datasets; the ``show()``/``print_schema()`` text of every stage
of the reference app is identical; the SQL subset filters like the JAX
engine and raises ``NotImplementedError`` outside its grammar.

The two fits agree within rtol 1e-9 (``test_torch_pipeline.py``) but not
bit for bit, since XLA's and PyTorch's CPU matrix products sum in
different orders; so the stages after the fit (``transform`` and the
residuals) print the JAX model's coefficients, carried into the port
through ``interop``, and their text must then match character for
character."""

import numpy as np
import pytest
import torch

from conftest import dataset_path
from sparkdq4ml_tpu.frame.csv import read_csv as jax_read_csv
from sparkdq4ml_tpu_torch import TorchSession
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame import Frame, read_csv
from sparkdq4ml_tpu_torch.ops import expressions as E
from sparkdq4ml_tpu_torch.sql import default_catalog, parse

DATASETS = ["abstract", "small", "full"]


@pytest.fixture
def port():
    with float_policy(torch.float64):
        s = (TorchSession.builder().app_name("test")
             .config("spark.torch.device", "cpu").get_or_create())
        yield s
        s.stop()
        default_catalog().clear()


@pytest.mark.parametrize("name", DATASETS)
def test_read_csv_matches_jax(port, name):
    ref = jax_read_csv(dataset_path(name), header=False, infer_schema=True)
    got = port.read.format("csv").option("inferSchema", "true").option(
        "header", "false").load(dataset_path(name))
    assert got.columns == ref.columns == ["_c0", "_c1"]
    assert got.dtypes() == ref.dtypes() == [("_c0", "integer"),
                                            ("_c1", "double")]
    assert got.count() == ref.count()
    d, r = got.to_pydict(), ref.to_pydict()
    for c in ref.columns:
        assert d[c].dtype == r[c].dtype
        np.testing.assert_array_equal(d[c], r[c])


def test_read_csv_records_and_nulls(tmp_path):
    p = tmp_path / "mixed.csv"
    p.write_bytes(b"1,2.5,a\r2,,b\n\n3,4.0,c\r\n")
    with float_policy(torch.float64):
        f = read_csv(str(p), device="cpu")
    assert f.columns == ["_c0", "_c1", "_c2"]
    assert f.dtypes() == [("_c0", "integer"), ("_c1", "double"),
                          ("_c2", "string")]
    d = f.to_pydict()
    assert d["_c0"].tolist() == [1, 2, 3]
    assert np.isnan(d["_c1"][1]) and d["_c2"].tolist() == ["a", "b", "c"]
    quoted = tmp_path / "q.csv"
    quoted.write_text('1,"a"\n')
    with pytest.raises(NotImplementedError, match="quoted"):
        read_csv(str(quoted), device="cpu")


def _app_stages(dq, session, path, VectorAssembler):
    """Every show()/print_schema() of the reference app up to the fit."""
    session.udf.register("minimumPriceRule", dq.minimum_price_rule, "double")
    session.udf.register("priceCorrelationRule", dq.price_correlation_rule,
                         "double")
    df = (session.read.format("csv").option("inferSchema", "true")
          .option("header", "false").load(path))
    df = df.with_column_renamed("_c0", "guest").with_column_renamed(
        "_c1", "price")
    df.show()
    df = df.with_column("price_no_min",
                        dq.call_udf("minimumPriceRule", df.col("price")))
    df.print_schema()
    df.show(50)
    df.create_or_replace_temp_view("price")
    df = session.sql("SELECT cast(guest as int) guest, price_no_min AS price "
                     "FROM price WHERE price_no_min > 0")
    df.print_schema()
    df.show(50)
    df = df.with_column("price_correct_correl",
                        dq.call_udf("priceCorrelationRule", df.col("price"),
                                    df.col("guest")))
    df.create_or_replace_temp_view("price")
    df = session.sql("SELECT guest, price_correct_correl AS price "
                     "FROM price WHERE price_correct_correl > 0")
    df.show(50)
    df = df.with_column("label", df.col("price"))
    df = VectorAssembler().setInputCols(["guest"]).setOutputCol(
        "features").transform(df)
    df.print_schema()
    df.show()
    return df


def _model_stages(model, df):
    model.transform(df).show()
    model.evaluate(df).residuals.show()


@pytest.mark.parametrize("name", DATASETS)
def test_show_and_schema_text_matches_jax(port, session, capsys, name):
    import sparkdq4ml_tpu as jdq
    import sparkdq4ml_tpu_torch as tdq
    from sparkdq4ml_tpu.models import LinearRegression as JLR
    from sparkdq4ml_tpu.models import VectorAssembler as JVA
    from sparkdq4ml_tpu_torch.models import VectorAssembler as TVA

    from sparkdq4ml_tpu_torch.interop import linear_model_from_numpy

    jdf = _app_stages(jdq, session, dataset_path(name), JVA)
    jmodel = (JLR().setMaxIter(40).setRegParam(1).setElasticNetParam(1)
              .fit(jdf))
    _model_stages(jmodel, jdf)
    ref = capsys.readouterr().out
    tdf = _app_stages(tdq, port, dataset_path(name), TVA)
    tmodel = linear_model_from_numpy(jmodel.coefficients, jmodel.intercept,
                                     jmodel._params)
    _model_stages(tmodel, tdf)
    got = capsys.readouterr().out
    assert got.count("root\n") == 3 and got.count("+\n|") >= 8
    assert got == ref


WHERES = ["price > 100", "price >= 30 AND guest < 10",
          "NOT (price > 50) OR guest = 25", "guest <> 8 AND price != 120.0",
          "cast(price as int) == 30", "price <= 23.1"]


@pytest.mark.parametrize("where", WHERES)
def test_where_matches_jax(port, session, where):
    q = f"SELECT guest, cast(price as int) AS p, price FROM v WHERE {where}"
    results = []
    for s in (session, port):
        df = (s.read.format("csv").option("inferSchema", "true")
              .load(dataset_path("abstract")))
        df = df.with_column_renamed("_c0", "guest").with_column_renamed(
            "_c1", "price")
        df.create_or_replace_temp_view("v")
        out = s.sql(q)
        results.append((out.columns, out.dtypes(), out.to_pydict()))
    (c1, t1, d1), (c2, t2, d2) = results
    assert c1 == c2 == ["guest", "p", "price"] and t1 == t2
    for c in c1:
        np.testing.assert_array_equal(d1[c], d2[c])


@pytest.mark.parametrize("sql", [
    # set operations
    "SELECT guest FROM v UNION SELECT guest FROM w",
    "SELECT guest FROM v UNION ALL SELECT guest FROM w",
    "SELECT guest FROM v INTERSECT SELECT guest FROM w",
    "SELECT guest FROM v EXCEPT SELECT guest FROM w",
    "WITH w AS (SELECT guest FROM v) SELECT guest FROM w UNION "
    "SELECT guest FROM v",
    "SELECT guest FROM v WHERE guest IN (SELECT guest FROM w UNION "
    "SELECT guest FROM v)",
    # EXPLAIN
    "EXPLAIN SELECT guest FROM v", "EXPLAIN ANALYZE SELECT guest FROM v",
    "EXPLAIN WITH w AS (SELECT guest FROM v) SELECT guest FROM w",
    # correlated subqueries
    "SELECT guest FROM v a WHERE EXISTS (SELECT guest FROM w b WHERE "
    "b.guest = a.guest)",
    "SELECT guest FROM v a WHERE price > (SELECT avg(price) FROM w b "
    "WHERE b.guest = a.guest)",
    "SELECT guest FROM v a WHERE guest IN (SELECT guest FROM w b WHERE "
    "b.price > a.price)"])
def test_sql_outside_subset_raises(sql):
    with pytest.raises(NotImplementedError):
        parse(sql)


def test_cast_to_int_matches_xla_conversion():
    """NaN -> 0, saturation at the int32 range, truncation toward zero."""
    vals = [np.nan, 1e10, -1e10, 2.7, -2.7, np.inf, 0.5]
    f = Frame({"x": torch.tensor(vals, dtype=torch.float64)}, device="cpu")
    got = E.Cast(E.Col("x"), "int").eval(f)
    assert got.dtype == torch.int32
    assert got.tolist() == [0, 2147483647, -2147483648, 2, -2, 2147483647,
                            0]


def test_filter_masks_without_compacting():
    f = Frame({"a": torch.tensor([1.0, float("nan"), 3.0, 0.0])},
              device="cpu")
    g = f.filter(E.Col("a")).filter(E.Col("a") < 3)
    assert g.num_slots == 4 and g.count() == 1
    assert g.mask.tolist() == [True, False, False, False]


def test_unsupported_expressions_raise():
    strings = Frame({"a": ["x", "y"]}, device="cpu")
    with pytest.raises(NotImplementedError, match=r"operator \+"):
        (E.Col("a") + 1).eval(strings)
    with pytest.raises(NotImplementedError, match="literal"):
        E.Lit([1])
    with pytest.raises(NotImplementedError, match="SQL type"):
        E.Cast(E.Col("a"), "date")
