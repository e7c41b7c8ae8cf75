"""Qualified column names and correlated subqueries in the torch port's
SQL against the JAX package's ``session.sql`` on the same views, under
both float policies: ``alias.col`` over FROM, JOIN and derived-table
aliases (the view name when no alias is given, ``<name>_right`` for the
right side's duplicate column, a literal dotted column first), qualified
ON, aggregates, GROUP BY, HAVING and ORDER BY; correlated ``[NOT]
EXISTS`` and ``[NOT] IN`` rewritten to LEFT SEMI and LEFT ANTI joins
(a correlated NOT IN keeps the anti join's null rule), each against its
explicit join; and every correlation the rewrite refuses, with the JAX
package's ValueError. The cases mirror ``tests/test_sql_qualified.py`` and
``tests/test_sql_subqueries.py`` (the correlated and set-operation
classes).

Tolerance: names, dtypes, rows and order exact; sums rtol 1e-12 under
float64 and 1e-5 under float32.
"""

import numpy as np
import pytest
from test_torch_aggregates_extra import (assert_frames, policy,  # noqa: F401
                                         sessions)

T = {"guest": [2.0, 10.0, 14.0, 20.0, np.nan, 10.0],
     "price": [30.0, 95.0, 120.0, 200.0, 50.0, np.nan],
     "name": np.asarray(["a", "b", None, "d", "e", "b"], dtype=object)}
G = {"guest": [10.0, 14.0, 20.0, np.nan, 20.0],
     "price": [1.0, 2.0, 200.0, 50.0, 3.0],
     "tag": [7.0, 1.0, 8.0, 9.0, 2.0],
     "name": np.asarray(["b", "c", None, "e", "d"], dtype=object)}


@pytest.fixture
def views(sessions):
    jax_session, port, rtol = sessions
    for s in (jax_session, port):
        s.createDataFrame(dict(T)).create_or_replace_temp_view("t")
        s.createDataFrame(dict(G)).create_or_replace_temp_view("g")
        s.createDataFrame({"a.b": [1.0, 2.0], "c": [3.0, 4.0]}
                          ).create_or_replace_temp_view("dotted")
    return jax_session, port, rtol


QUALIFIED = {
    "view_name_qualifier": "SELECT t.price FROM t WHERE t.guest > 5",
    "as_alias": "SELECT x.price FROM t AS x WHERE x.guest > 5",
    "bare_alias": "SELECT x.price, x.name FROM t x WHERE x.guest > 5",
    "join_disambiguation": "SELECT t.price, g.price, g.tag FROM t JOIN g "
                           "USING (guest)",
    "qualified_on": "SELECT t.price, g.tag FROM t JOIN g ON t.guest = "
                    "g.guest",
    "left_join_qualified": "SELECT t.guest, g.tag FROM t LEFT JOIN g ON "
                           "t.guest = g.guest ORDER BY t.guest",
    "aggregates": "SELECT max(t.price) AS mp, median(t.price) AS md FROM t",
    "post_aggregate": "SELECT max(t.price) - min(t.price) AS sp FROM t",
    "group_and_order": "SELECT t.guest, count(*) AS n FROM t GROUP BY "
                       "t.guest ORDER BY t.guest DESC",
    "having": "SELECT t.guest, avg(t.price) AS ap FROM t GROUP BY t.guest "
              "HAVING avg(t.price) > 40",
    "semi_join_keys": "SELECT t.price FROM t LEFT SEMI JOIN g USING "
                      "(guest)",
    "literal_dotted_column_wins": "SELECT a.b FROM dotted WHERE a.b > 1",
    "inside_in_subquery": "SELECT t.price FROM t WHERE t.guest IN (SELECT "
                          "guest FROM g)",
    "derived_alias": "SELECT s.price FROM (SELECT guest, price FROM t) s "
                     "WHERE s.guest > 5",
    "join_derived_alias": "SELECT t.price, x.tag FROM t JOIN (SELECT "
                          "guest, tag FROM g) x USING (guest)",
    "unaliased_derived_offset": "SELECT price FROM (SELECT price FROM t) "
                                "OFFSET 2",
    "string_column": "SELECT g.name, t.price FROM t JOIN g USING (guest) "
                     "WHERE g.name IS NOT NULL",
}


@pytest.mark.parametrize("name", sorted(QUALIFIED))
def test_qualified_names(views, name):
    jax_session, port, rtol = views
    sql = QUALIFIED[name]
    assert_frames(port.sql(sql), jax_session.sql(sql), rtol, ("ap",))


@pytest.mark.parametrize("sql,match", [
    ("SELECT t.price FROM t AS x", "unknown relation alias"),
    ("SELECT z.price FROM t", "unknown relation alias"),
    ("SELECT t.nope FROM t", "not found in relation"),
    ("SELECT g.tag FROM t LEFT SEMI JOIN g USING (guest)",
     "not found in relation"),
    ("SELECT t.price FROM t JOIN g ON t.guest = g.tag",
     "shared column name"),
])
def test_qualified_errors(views, sql, match):
    jax_session, port, _ = views
    for s in (jax_session, port):
        with pytest.raises(ValueError, match=match):
            s.sql(sql)


CORRELATED = {
    "exists": ("SELECT price FROM t WHERE EXISTS (SELECT 1 FROM g WHERE "
               "g.guest = t.guest)",
               "SELECT price FROM t LEFT SEMI JOIN g USING (guest)"),
    "not_exists": ("SELECT price FROM t WHERE NOT EXISTS (SELECT 1 FROM g "
                   "WHERE g.guest = t.guest)",
                   "SELECT price FROM t LEFT ANTI JOIN g USING (guest)"),
    "exists_aliases": ("SELECT c.guest, c.price FROM t c WHERE EXISTS "
                       "(SELECT 1 FROM g r WHERE r.guest = c.guest)",
                       "SELECT guest, price FROM t LEFT SEMI JOIN g USING "
                       "(guest)"),
    "exists_inner_filter": ("SELECT price FROM t WHERE EXISTS (SELECT 1 "
                            "FROM g WHERE g.guest = t.guest AND g.tag > 1)",
                            None),
    "exists_and_outer_predicate": ("SELECT price FROM t WHERE EXISTS "
                                   "(SELECT 1 FROM g WHERE g.guest = "
                                   "t.guest) AND price < 150", None),
    "in": ("SELECT price FROM t WHERE guest IN (SELECT guest FROM g WHERE "
           "g.guest = t.guest AND tag > 1)", None),
    "not_in_null_rule": ("SELECT guest, price FROM t WHERE guest NOT IN "
                         "(SELECT guest FROM g WHERE g.guest = t.guest)",
                         "SELECT guest, price FROM t LEFT ANTI JOIN g USING "
                         "(guest)"),
    "in_two_keys": ("SELECT c.guest, c.price FROM t c WHERE c.price IN "
                    "(SELECT r.price FROM g r WHERE r.guest = c.guest)",
                    "SELECT guest, price FROM t LEFT SEMI JOIN g USING "
                    "(guest, price)"),
    "exists_string_key": ("SELECT c.name FROM t c WHERE EXISTS (SELECT 1 "
                          "FROM g r WHERE r.name = c.name)",
                          "SELECT name FROM t LEFT SEMI JOIN g USING "
                          "(name)"),
    "two_correlations": ("SELECT guest FROM t WHERE EXISTS (SELECT 1 FROM "
                         "g WHERE g.guest = t.guest) AND NOT EXISTS "
                         "(SELECT 1 FROM g WHERE g.price = t.price)", None),
    "reversed_equality": ("SELECT price FROM t WHERE EXISTS (SELECT 1 FROM "
                          "g WHERE t.guest = g.guest AND g.tag < 8)", None),
    "uncorrelated_stays": ("SELECT price FROM t WHERE EXISTS (SELECT 1 FROM "
                           "g WHERE g.tag > 8)", None),
}


@pytest.mark.parametrize("name", sorted(CORRELATED))
def test_correlated(views, name):
    jax_session, port, _ = views
    sql, join = CORRELATED[name]
    got = port.sql(sql)
    assert_frames(got, jax_session.sql(sql))
    if join is not None:
        assert_frames(got, port.sql(join))


@pytest.mark.parametrize("sql,match", [
    ("SELECT guest FROM t WHERE EXISTS (SELECT 1 FROM g WHERE g.tag > "
     "t.guest)", "non-equi"),
    ("SELECT guest FROM t WHERE EXISTS (SELECT count(*) FROM g WHERE "
     "g.guest = t.guest GROUP BY tag)", "set ops, grouping"),
    ("SELECT guest FROM t WHERE EXISTS (SELECT 1 FROM g WHERE g.guest = "
     "t.guest LIMIT 1)", "set ops, grouping"),
    ("SELECT guest FROM t WHERE price + 1 IN (SELECT price FROM g WHERE "
     "g.guest = t.guest)", "plain column"),
    ("SELECT guest FROM t WHERE EXISTS (SELECT 1 FROM g WHERE g.guest = "
     "t.guest AND g.price = t.guest)", "two different correlation keys"),
    ("SELECT guest FROM t WHERE price > (SELECT avg(price) FROM g WHERE "
     "g.guest = t.guest)", "correlated subqueries are not supported"),
])
def test_unsupported_correlations(views, sql, match):
    jax_session, port, _ = views
    for s in (jax_session, port):
        with pytest.raises(ValueError, match=match):
            s.sql(sql)
