"""The torch port's SQL core (``sql/parser.py`` over the grouped engine,
joins and windows) against the JAX package's ``session.sql`` on the same
views: every SQL form of the relational core, the SQL tour's sections 1-6
on dataset-full through both packages, ``chip_smoke.SQL_TOUR_GOLDEN`` held
to the JAX package's output, ``show()`` text, ``NotImplementedError``
outside the subset, and the chip script's 10^7-row phase run on the CPU at
a small size.

Tolerance: names, dtypes, row order, keys, counts and ranks exact; float64
sums, averages and variances rtol 1e-9 (under the float32 policy the port
is held to the golden at ``chip_smoke.TOUR_RTOL``, 1e-5).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from conftest import dataset_path
from sparkdq4ml_tpu import functions as JF
from sparkdq4ml_tpu.frame.window import Window as JWindow
from sparkdq4ml_tpu.ops.expressions import Col as JCol
from sparkdq4ml_tpu_torch import TorchSession
from sparkdq4ml_tpu_torch import functions as TF
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.window import Window as TWindow
from sparkdq4ml_tpu_torch.ops.expressions import Col as TCol
from sparkdq4ml_tpu_torch.sql import default_catalog

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-9


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


smoke = _smoke()


def port_session():
    return (TorchSession.builder().app_name("test")
            .config("spark.torch.device", "cpu").get_or_create())


@pytest.fixture
def port():
    with float_policy(torch.float64):
        s = port_session()
        yield s
        s.stop()
        default_catalog().clear()


@pytest.fixture
def views(port, session):
    """The tour's ``clean`` and ``busy`` views in both packages."""
    path = dataset_path("full")
    for s in (session, port):
        smoke.tour_clean(s, path)
        s.sql("SELECT guest, COUNT(*) AS n, AVG(price) AS avg_price FROM "
              "clean GROUP BY guest HAVING COUNT(*) > 10 ORDER BY guest"
              ).create_or_replace_temp_view("busy")
        s.createDataFrame({"guest": np.arange(0, 40, 2).astype(np.int32),
                           "tag": np.arange(0, 400, 20.0)}
                          ).create_or_replace_temp_view("keys")
    return session, port


def assert_same(got, want, approx=()):
    assert got.columns == want.columns
    assert got.dtypes() == want.dtypes()
    dg, dw = got.to_pydict(), want.to_pydict()
    for c in want.columns:
        a, b = np.asarray(dg[c]), np.asarray(dw[c])
        assert a.shape == b.shape and a.dtype == b.dtype, c
        if c in approx:
            np.testing.assert_allclose(a, b, rtol=RTOL, equal_nan=True,
                                       err_msg=c)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)


FORMS = {
    "group_having_order": (
        "SELECT guest, COUNT(*) AS n, SUM(price) AS s, AVG(price) AS a, "
        "MIN(price) AS lo, MAX(price) AS hi, STDDEV(price) AS sd FROM clean "
        "GROUP BY guest HAVING COUNT(*) > 10 ORDER BY guest", ("s", "a",
                                                              "sd")),
    "count_distinct": ("SELECT guest, COUNT(DISTINCT price) FROM clean "
                       "GROUP BY guest", ()),
    "group_by_float": ("SELECT price, COUNT(*) AS n FROM clean GROUP BY "
                       "price", ()),
    "group_position_order_agg": (
        "SELECT guest, count(*) FROM clean GROUP BY 1 ORDER BY count(*) "
        "DESC, 1", ()),
    "group_expression": ("SELECT cast(price / 50 as int) AS band, "
                         "AVG(price) AS a FROM clean GROUP BY "
                         "cast(price / 50 as int) ORDER BY band", ("a",)),
    "having_only_agg": ("SELECT guest FROM clean GROUP BY guest HAVING "
                        "max(price) > 150 AND count(*) > 20", ()),
    "order_limit": ("SELECT guest, price FROM clean ORDER BY price DESC "
                    "LIMIT 5", ()),
    "order_offset": ("SELECT guest, price FROM clean ORDER BY guest, price "
                     "DESC LIMIT 4 OFFSET 3", ()),
    "order_nulls": ("SELECT guest, price FROM clean ORDER BY price "
                    "NULLS LAST, guest", ()),
    "order_hidden_key": ("SELECT price FROM clean ORDER BY guest DESC, "
                         "price", ()),
    "distinct": ("SELECT DISTINCT guest FROM clean", ()),
    "join_using": ("SELECT guest, price, avg_price FROM clean JOIN busy "
                   "USING (guest)", ()),
    "join_on": ("SELECT guest, price, n FROM clean INNER JOIN busy ON "
                "clean.guest = busy.guest WHERE price > avg_price", ()),
    "left_semi": ("SELECT price FROM clean LEFT SEMI JOIN busy USING "
                  "(guest)", ()),
    "left_anti": ("SELECT guest FROM clean LEFT ANTI JOIN keys USING "
                  "(guest)", ()),
    "left_outer": ("SELECT guest, price, tag FROM clean LEFT JOIN keys "
                   "USING (guest)", ()),
    "full_outer": ("SELECT * FROM keys FULL OUTER JOIN busy USING "
                   "(guest)", ()),
    "window_sql": (
        "SELECT guest, price, DENSE_RANK() OVER (PARTITION BY guest ORDER BY "
        "price) AS rk, first_value(price) OVER (PARTITION BY guest ORDER BY "
        "price) AS cheapest, lag(price, 1) OVER (PARTITION BY guest ORDER "
        "BY price DESC) AS prev FROM clean", ()),
    "window_rows_frame": (
        "SELECT guest, SUM(price) OVER (PARTITION BY guest ORDER BY price "
        "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS run, "
        "avg(price) OVER (PARTITION BY guest) FROM clean", ("run",)),
    "arithmetic": ("SELECT guest, price / guest AS ppg, price * 2 + 1, "
                   "-price, price % 7, guest / 0 AS z FROM clean WHERE "
                   "price - 10 > guest * 3", ()),
    "derived_spread": (
        "SELECT guest, max(price) - min(price) AS spread FROM (SELECT guest, "
        "price FROM clean WHERE guest > 1) g GROUP BY guest ORDER BY "
        "max(price) - min(price) DESC LIMIT 3", ()),
    "global_agg": ("SELECT count(*) AS n, avg(price), max(price) - "
                   "min(price) AS r FROM clean", ("avg(price)",)),
    "global_host_valued": ("SELECT count(DISTINCT guest) AS g, sum(DISTINCT "
                           "guest), first(price), stddev_pop(price) AS sp "
                           "FROM clean WHERE guest > 3", ("sp",)),
    "star_expr": ("SELECT *, price / 2 AS half FROM clean ORDER BY price "
                  "LIMIT 10", ()),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_sql_form_matches_jax(views, form):
    session, port = views
    sql, approx = FORMS[form]
    assert_same(port.sql(sql), session.sql(sql), approx)


def test_fluent_forms_match_jax(views):
    session, port = views
    got, want = [], []
    for s, F, W, C, out in ((port, TF, TWindow, TCol, got),
                            (session, JF, JWindow, JCol, want)):
        clean = s.sql("SELECT * FROM clean")
        w = W.partition_by("guest").order_by("price")
        out.append(clean.group_by("guest").agg(
            F.count().alias("n"), F.avg("price").alias("avg_price"))
            .filter(C("n") > 10).sort("guest"))
        out.append(clean.sort("guest", C("price").desc()))
        out.append(clean.distinct())
        out.append(clean.drop_duplicates(["guest"]))
        out.append(clean.with_column("rk", F.dense_rank().over(w))
                   .with_column("prev", F.lag("price", 1).over(w)))
        feat = clean.select_expr("guest", "price",
                                 "price / guest AS price_per_guest")
        out.append(feat.na.drop())
        out.append(feat.limit(7))
    for g, w in zip(got, want):
        assert_same(g, w, ("avg_price",))
    assert got[-1].take(3) == want[-1].take(3)
    assert got[-1].first() == want[-1].first()


def test_tour_sections_match_jax(port, session):
    path = dataset_path("full")
    got = smoke.sql_tour(port, TF, TWindow, TCol,
                         smoke.tour_clean(port, path))
    want = smoke.sql_tour(session, JF, JWindow, JCol,
                          smoke.tour_clean(session, path))
    smoke.check_tour(got, want, RTOL, "port against JAX")


def test_chip_smoke_tour_golden_is_the_reference_output(session):
    """The constant ``chip_smoke.py`` holds the card to is the JAX
    package's float64 output; the port meets it under the float32
    policy too."""
    want = smoke.sql_tour(session, JF, JWindow, JCol, smoke.tour_clean(
        session, dataset_path("full")))
    smoke.check_tour(smoke.SQL_TOUR_GOLDEN, want, RTOL, "golden")
    assert want["fluent_equals_sql_rank"]
    with float_policy(torch.float32):
        s = port_session()
        got = smoke.sql_tour(s, TF, TWindow, TCol, smoke.tour_clean(
            s, dataset_path("full")))
        s.stop()
        default_catalog().clear()
    smoke.check_tour(got, smoke.SQL_TOUR_GOLDEN, smoke.TOUR_RTOL,
                     "port float32")


def test_show_text_matches(views, capsys):
    session, port = views
    for s in (session, port):
        s.sql("SELECT guest, COUNT(*) AS n, AVG(price) AS avg_price FROM "
              "clean GROUP BY guest HAVING COUNT(*) > 10 ORDER BY guest"
              ).show(5)
        s.sql("SELECT guest, price, DENSE_RANK() OVER (PARTITION BY guest "
              "ORDER BY price) AS rk FROM clean ORDER BY price DESC").show(3)
        s.sql("SELECT * FROM keys LEFT JOIN busy USING (guest)").show(4)
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:] and "only showing top 5 rows" in out


@pytest.mark.parametrize("sql,match", [
    ("SELECT cast(guest AS bigint) FROM clean", "bigint"),
    ("SELECT cast(guest AS timestamp) FROM clean", "timestamp"),
    ("SELECT guest <=> price FROM clean", "<=>"),
    ("SELECT guest FROM clean GROUP BY GROUPING SETS ((guest))", "SETS"),
    ("CREATE TABLE p AS SELECT guest FROM clean", "CREATE"),
    ("EXPLAIN SELECT guest <=> price FROM clean", "<=>"),
    ("EXPLAIN ANALYZE SELECT cast(guest AS bigint) FROM clean", "bigint"),
    ("DESCRIBE clean", "DESCRIBE"),
])
def test_outside_the_subset_raises(views, sql, match):
    _, port = views
    with pytest.raises(NotImplementedError, match=match):
        port.sql(sql)


def test_string_key_raises(port):
    """String keys group and sort ascending, and a string column takes
    max; a sum over a string column and a descending string sort
    raise."""
    port.createDataFrame({"city": ["ny", "sf", "ny"], "v": [1.0, 2.0, 3.0]}
                         ).create_or_replace_temp_view("t")
    assert port.sql("SELECT city, count(*) AS n FROM t GROUP BY city "
                    "ORDER BY city").to_pydict()["n"].tolist() == [2, 1]
    assert port.sql("SELECT v, max(city) AS m FROM t GROUP BY v"
                    ).to_pydict()["m"].tolist() == ["ny", "sf", "ny"]
    with pytest.raises(NotImplementedError, match="string"):
        port.sql("SELECT v, sum(city) FROM t GROUP BY v")
    with pytest.raises(ValueError, match="descending"):
        port.sql("SELECT city FROM t ORDER BY city DESC")


def test_chip_smoke_sql_core_phase_runs_on_the_cpu():
    """The chip script's 10^7-row phase, at 20,000 rows on the CPU: the
    float32 run against the float64 run through its own comparison, its
    steps 1-2 bit-identical over two runs."""
    guest, price = smoke.full_table(20_000)
    with float_policy(torch.float32):
        spark, clean = smoke.clean_table("cpu", guest, price)
        outs = smoke.run_sql_core(spark, clean, runs=2)
        kept32 = clean.count()
        spark.stop()
    card = smoke.summarize_sql_core(smoke.first_runs(outs))
    again = smoke.summarize_sql_core({k: outs[k][1] for k in (
        "group_by", "sorted_groups")})
    assert smoke.bit_identical({k: card[k] for k in again}, again) == []
    assert len({r["over"].count() for r in outs["join"]}) == 1
    cpu = smoke.cpu_reference(guest, price)
    default_catalog().clear()
    assert kept32 == cpu["clean_rows"] > 18_000
    errs = smoke.check_sql_core(card, cpu["core"])
    assert len(card) == len(cpu["core"]) == 18
    n_card, n_cpu = errs.pop("join.over rows (card, cpu)")
    assert abs(n_card - n_cpu) < 100 < n_cpu
    assert all(v <= smoke.SQL_ROWS_RTOL for v in errs.values())


def test_chip_smoke_sql_rest_phase_runs_on_the_cpu():
    """Phase 8 at 20,000 rows on the CPU: float32 against float64, steps
    1-4 bit-identical over two runs, IN (subquery) rows equal to LEFT
    SEMI's, the band's keys, codes and DDL result as expected."""
    guest, price = smoke.full_table(20_000)
    with float_policy(torch.float32):
        spark, clean = smoke.clean_table("cpu", guest, price)
        outs = smoke.run_sql_rest(spark, clean, runs=2)
        spark.stop()
    card = smoke.summarize_sql_core(smoke.first_runs(outs))
    again = smoke.summarize_sql_core({k: outs[k][1] for k in (
        "cte", "in_semi", "predicates", "string_keys")})
    assert smoke.bit_identical({k: card[k] for k in again}, again) == []
    assert smoke.bit_identical({"x": card["in_semi.in"]},
                               {"x": card["in_semi.semi"]}) == []
    cpu = smoke.cpu_reference(guest, price)
    default_catalog().clear()
    errs = smoke.check_sql_core(card, cpu["rest"])
    assert set(errs) == {"string_keys.group.avg_price",
                         "string_keys.group.sd"}
    assert all(v <= smoke.SQL_ROWS_RTOL for v in errs.values())
    group = card["string_keys.group"]
    assert group["band"].tolist() == ["large", "medium", "small"]
    assert sorted(card["string_keys.distinct"]["band"].tolist()) == [
        "large", "medium", "small"]
    assert 0 < card["in_semi.in"]["guest"].size < 19_000
    assert set(card["string_keys.like"]["guest"].tolist()) <= set(range(10))
    assert card["ddl.count"]["n"][0] > 0
