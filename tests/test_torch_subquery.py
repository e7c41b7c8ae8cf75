"""CTEs and uncorrelated subqueries in the torch port's SQL against the
JAX package's ``session.sql`` on the same views: ``WITH`` over an overlay
catalog (a CTE may shadow a view), scalar subqueries (read once to the
host as a literal; no row is NULL, two rows an error), ``[NOT] IN
(SELECT ...)`` as a semi join against the subquery's values (held to
``LEFT SEMI JOIN``), ``[NOT] EXISTS``, on numeric and string columns,
under both float policies.

Tolerance: names, dtypes, rows, order and keys exact; averages rtol 1e-9
under float64 and 1e-5 under float32 (the JAX side then runs with x64
off).
"""

import numpy as np
import pytest
from test_torch_grouped import assert_same, policy  # noqa: F401
from test_torch_sql_core import port_session, smoke

from conftest import dataset_path
from sparkdq4ml_tpu_torch.interop import string_columns
from sparkdq4ml_tpu_torch.sql import default_catalog


@pytest.fixture
def both(policy, session):
    """The tour's ``clean`` and ``busy`` views, a 20-row ``keys`` view and
    a seeded string view ``s`` (with its half ``s2``) in both packages,
    under one float policy; yields ``(jax session, port session, rtol)``."""
    port = port_session()
    cols = string_columns(50, seed=4)
    for s in (session, port):
        smoke.tour_clean(s, dataset_path("full"))
        s.sql("SELECT guest, COUNT(*) AS n, AVG(price) AS avg_price FROM "
              "clean GROUP BY guest HAVING COUNT(*) > 10 ORDER BY guest"
              ).create_or_replace_temp_view("busy")
        s.createDataFrame({"guest": np.arange(0, 40, 2).astype(np.int32),
                           "tag": np.arange(0, 400, 20.0)}
                          ).create_or_replace_temp_view("keys")
        s.createDataFrame({k: cols[k] for k in ("name", "k", "v")}
                          ).create_or_replace_temp_view("s")
        s.sql("SELECT name, k FROM s WHERE k < 2"
              ).create_or_replace_temp_view("s2")
    yield session, port, policy
    port.stop()
    default_catalog().clear()


FORMS = {
    "cte_scalar_avg": (
        "WITH stats AS (SELECT avg(price) AS ap FROM clean) SELECT guest, "
        "price FROM clean WHERE price > (SELECT ap FROM stats) ORDER BY "
        "price DESC LIMIT 5", ()),
    "scalar_in_select": (
        "SELECT guest, price - (SELECT avg(price) FROM clean) AS d FROM "
        "clean WHERE guest < 4", ("d",)),
    "scalar_no_row_is_null": (
        "SELECT guest FROM clean WHERE price > (SELECT max(price) FROM "
        "clean WHERE guest > 100)", ()),
    "having_scalar": (
        "SELECT guest, count(*) AS n FROM clean GROUP BY guest HAVING "
        "count(*) > (SELECT avg(n) FROM busy) ORDER BY guest", ()),
    "in_subquery": ("SELECT price FROM clean WHERE guest IN (SELECT guest "
                    "FROM busy)", ()),
    "in_subquery_and": (
        "SELECT guest, price FROM clean WHERE guest IN (SELECT guest FROM "
        "busy WHERE n > 30) AND price > 100", ()),
    "not_in_subquery": ("SELECT guest, price FROM clean WHERE guest NOT IN "
                        "(SELECT guest FROM keys)", ()),
    "in_subquery_of_floats": (
        "SELECT guest FROM clean WHERE price IN (SELECT price FROM clean "
        "WHERE guest = 7)", ()),
    "exists": ("SELECT guest FROM keys WHERE EXISTS (SELECT guest FROM busy "
               "WHERE n > 30)", ()),
    "not_exists": ("SELECT guest FROM keys WHERE NOT EXISTS (SELECT guest "
                   "FROM busy WHERE n > 1000)", ()),
    "two_ctes": (
        "WITH a AS (SELECT guest, price FROM clean WHERE guest > 30), b AS "
        "(SELECT guest, count(*) AS n, avg(price) AS ap FROM a GROUP BY "
        "guest) SELECT * FROM b ORDER BY guest", ("ap",)),
    "cte_join": (
        "WITH b AS (SELECT guest, max(price) AS top FROM clean GROUP BY "
        "guest) SELECT guest, price, top FROM clean JOIN b USING (guest) "
        "WHERE price = top", ()),
    "cte_shadows_a_view": (
        "WITH clean AS (SELECT guest, price FROM clean WHERE guest < 3) "
        "SELECT count(*) AS n, min(guest) AS lo FROM clean", ()),
    "in_subquery_strings": ("SELECT name, v FROM s WHERE name IN (SELECT "
                            "name FROM s2)", ()),
    "not_in_subquery_strings_with_null": (
        "SELECT name FROM s WHERE name NOT IN (SELECT name FROM s2)", ()),
    "not_in_subquery_strings": (
        "SELECT name FROM s WHERE name NOT IN (SELECT name FROM s2 WHERE "
        "name IS NOT NULL)", ()),
    "scalar_string": ("SELECT k, v FROM s WHERE name = (SELECT name FROM s "
                      "ORDER BY v DESC LIMIT 1) OR k = (SELECT min(k) FROM "
                      "s2)", ()),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_subquery_form_matches_jax(both, form):
    session, port, rtol = both
    sql, approx = FORMS[form]
    assert_same(port.sql(sql), session.sql(sql), rtol, approx)


def test_in_subquery_gives_the_semi_joins_rows(both):
    session, port, _ = both
    for s in (port, session):
        semi = s.sql("SELECT guest, price FROM clean LEFT SEMI JOIN busy "
                     "USING (guest)").to_pydict()
        in_sub = s.sql("SELECT guest, price FROM clean WHERE guest IN "
                       "(SELECT guest FROM busy)").to_pydict()
        for c in ("guest", "price"):
            np.testing.assert_array_equal(semi[c], in_sub[c])


def test_a_cte_leaves_the_catalog_as_it_was(both):
    _, port, _ = both
    before = port.sql("SELECT count(*) AS n FROM clean").to_pydict()["n"]
    port.sql("WITH clean AS (SELECT guest FROM clean WHERE guest < 3), "
             "busy AS (SELECT guest FROM clean) SELECT * FROM busy")
    assert port.sql("SELECT count(*) AS n FROM clean").to_pydict()["n"] == \
        before
    assert port.catalog.list_views() == ["busy", "clean", "inventory",
                                         "keys", "s", "s2"]


@pytest.mark.parametrize("sql,match", [
    ("SELECT guest FROM clean WHERE price > (SELECT avg_price FROM busy)",
     "more than one row"),
    ("SELECT guest FROM clean WHERE price > (SELECT guest, n FROM busy)",
     "one column"),
    ("SELECT guest FROM clean WHERE guest IN (SELECT guest, n FROM busy)",
     "one column"),
])
def test_subquery_shape_errors_match_jax(both, sql, match):
    session, port, _ = both
    for s in (port, session):
        with pytest.raises(ValueError, match=match):
            s.sql(sql)


def test_in_an_empty_subquery(both):
    """No value: IN holds for no row and NOT IN for every non-null row
    (the JAX package's numeric InList raises on an empty list)."""
    _, port, _ = both
    empty = "(SELECT guest FROM busy WHERE n > 1000)"
    assert port.sql(f"SELECT guest FROM clean WHERE guest IN {empty}"
                    ).count() == 0
    assert port.sql(f"SELECT guest FROM clean WHERE guest NOT IN {empty}"
                    ).count() == 1040


@pytest.mark.parametrize("sql", [
    "SELECT guest FROM clean c WHERE EXISTS (SELECT guest FROM busy b "
    "WHERE b.guest = c.guest)",
    "SELECT guest FROM clean c WHERE price > (SELECT avg(price) FROM clean "
    "d WHERE d.guest = c.guest)",
    "SELECT guest FROM clean c WHERE guest IN (SELECT guest FROM busy b "
    "WHERE b.n > c.guest)",
])
def test_correlated_subqueries_raise(both, sql):
    _, port, _ = both
    with pytest.raises(NotImplementedError, match="correlated"):
        port.sql(sql)
