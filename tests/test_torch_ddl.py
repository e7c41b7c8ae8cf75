"""Temp-view DDL in the torch port's SQL and its catalog against the JAX
package's: ``CREATE [OR REPLACE] [TEMP[ORARY]] VIEW name AS ...`` (a CTE
body included), ``DROP [TEMP] VIEW [IF EXISTS] name``, and
``session.catalog``'s ``table_exists``/``tableExists``, ``drop`` and
``list_views``, as ``examples/sql_tour.py`` drives them.

Tolerance: row counts, view names, results and errors exact.
"""

import numpy as np
import pytest
from test_torch_sql_core import port, port_session, smoke, views  # noqa: F401

from conftest import dataset_path

DDL = [
    "CREATE OR REPLACE TEMP VIEW premium AS SELECT guest, price FROM clean "
    "WHERE price > 90",
    "CREATE TEMPORARY VIEW premium AS SELECT guest, price FROM clean WHERE "
    "price > 90",
    "create view premium as select guest, price from clean where price > 90",
    "CREATE OR REPLACE VIEW premium AS WITH p AS (SELECT guest, price FROM "
    "clean WHERE price > 90) SELECT * FROM p",
]


@pytest.mark.parametrize("create", DDL)
@pytest.mark.parametrize("drop", ["DROP VIEW premium", "drop temp view "
                                  "premium", "DROP TEMPORARY VIEW IF EXISTS "
                                  "premium"])
def test_create_and_drop_round_trip_matches_jax(views, create, drop):
    session, port = views
    seen = []
    for s in (session, port):
        out = s.sql(create)
        assert out.columns == [] and out.count() == 0
        before = s.catalog.table_exists("premium")
        n = s.sql("SELECT count(*) AS n FROM premium").to_pydict()["n"][0]
        rows = s.sql("SELECT * FROM premium ORDER BY price DESC LIMIT 3"
                     ).to_pydict()
        s.sql(drop)
        seen.append((before, int(n), s.catalog.tableExists("premium"),
                     rows["guest"].tolist(), rows["price"].tolist()))
    assert seen[0] == seen[1]
    assert seen[1][0] is True and seen[1][2] is False and seen[1][1] > 0


def test_replace_and_missing_views_match_jax(views):
    session, port = views
    for s in (session, port):
        s.sql("CREATE OR REPLACE TEMP VIEW p AS SELECT guest FROM clean "
              "WHERE guest < 3")
        s.sql("CREATE OR REPLACE TEMP VIEW p AS SELECT guest FROM clean "
              "WHERE guest < 5")
        assert s.sql("SELECT count(*) AS n FROM p").to_pydict()["n"][0] == \
            port.sql("SELECT count(*) AS n FROM clean WHERE guest < 5"
                     ).to_pydict()["n"][0]
        s.sql("DROP VIEW p")
        s.sql("DROP VIEW IF EXISTS p")          # a missing view, no error
        with pytest.raises(KeyError, match="not found"):
            s.sql("DROP VIEW p")
        with pytest.raises(KeyError, match="not found"):
            s.sql("SELECT * FROM p")


def test_catalog_surface(port):
    cat = port.catalog
    assert cat.list_views() == []
    port.createDataFrame({"a": np.arange(3.0)}).create_or_replace_temp_view(
        "Mixed")
    assert cat.table_exists("mixed") and cat.tableExists("MIXED")
    assert cat.list_views() == ["mixed"]
    assert cat.drop("mixed") is True and cat.drop("mixed") is False
    assert not cat.table_exists("mixed")
    port.createDataFrame({"a": np.arange(3.0)}).create_or_replace_temp_view(
        "t")
    assert cat.dropTempView("t") and cat.list_views() == []


def test_the_tour_ddl_section(port, session):
    """examples/sql_tour.py's DDL section through both packages."""
    got = []
    for s in (session, port):
        smoke.tour_clean(s, dataset_path("full"))
        got.append(smoke.tour_ddl(s))
    assert got[0] == got[1]
    assert got[1]["exists_before"] and not got[1]["exists_after"]


def test_a_statement_that_is_not_ddl_still_parses(port):
    port.createDataFrame({"create_view": np.arange(3.0)}
                         ).create_or_replace_temp_view("v")
    out = port.sql("SELECT create_view FROM v WHERE create_view > 0")
    assert out.count() == 2
    with pytest.raises(NotImplementedError, match="CREATE"):
        port.sql("CREATE TABLE t AS SELECT create_view FROM v")
    with pytest.raises(NotImplementedError, match="DROP"):
        port.sql("DROP TABLE v")


def test_ddl_through_a_fresh_session_sees_the_shared_catalog():
    s = port_session()
    try:
        s.createDataFrame({"a": np.arange(4.0)}).create_or_replace_temp_view(
            "base")
        s.sql("CREATE TEMP VIEW two AS SELECT a FROM base WHERE a > 1")
        assert s.catalog.list_views() == ["base", "two"]
        s.sql("DROP VIEW two")
        assert s.catalog.list_views() == ["base"]
    finally:
        s.stop()
        s.catalog.clear()
