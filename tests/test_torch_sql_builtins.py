"""The builtin function library through the torch port's SQL and
``F.expr``, against the JAX package's ``session.sql`` on the same views:
``||``, ``extract(FIELD FROM x)``, ``LEFT``/``RIGHT`` in call position,
``if``, ``EXISTS(arr, x -> ...)`` beside ``EXISTS (SELECT ...)``, lambdas,
a SELECT without FROM, builtins and row functions by name; one statement
mixing the families on dataset-full; the chip script's phase 12 run on
the CPU at a small size, and its hash constants tied to the JAX package.

Tolerance: exact (names, dtypes, values, NaN positions and host cells),
but one average, ``round(avg(price), 2)``, within rtol 1e-9 before its
rounding (float64 sums in two orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_builtins_parity import assert_same_result
from test_torch_sql_core import port, smoke  # noqa: F401

from conftest import dataset_path
from sparkdq4ml_tpu import functions as JF
from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.ops import expressions as JE
from sparkdq4ml_tpu.ops.rules import dq_rules_fused as jax_dq_rules
from sparkdq4ml_tpu_torch import functions as TF
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.sql import default_catalog


def assert_frames(got, want, rtol=None, approx=()):
    assert got.columns == want.columns
    dg, dw = got.to_pydict(), want.to_pydict()
    for c in want.columns:
        assert_same_result(dg[c], dw[c], rtol if c in approx else None, c)


@pytest.fixture
def views(port, session):  # noqa: F811
    """dataset-full's clean rows as ``clean`` (with a string band and an
    array column) and a small table with nulls as ``t``, in both
    packages."""
    path = dataset_path("full")
    for s in (session, port):
        smoke.tour_clean(s, path)
        s.sql("SELECT guest, price, CASE WHEN guest < 10 THEN 'small' WHEN "
              "guest < 25 THEN 'medium' ELSE 'large' END AS band FROM clean"
              ).create_or_replace_temp_view("banded")
        s.createDataFrame({
            "k": np.arange(6, dtype=np.int32),
            "x": np.asarray([1.5, np.nan, -2.25, 0.0, 10.0, -0.5]),
            "s": np.asarray(["ab", None, "", "Hello", "x y", "zz"],
                            dtype=object),
            "d": np.asarray(["2019-01-31", "1969-12-31", None,
                             "2000-02-29 10:11:12", "junk", "2100-02-28"],
                            dtype=object)}).create_or_replace_temp_view("t")
    yield session, port


SQL_FORMS = {
    "concat_op": "SELECT s || '-' || CAST(k AS string) AS c, s || x FROM t",
    "extract": "SELECT extract(year FROM d) AS y, extract(month FROM d) AS "
               "m, extract(day FROM d) AS dd, extract(dow FROM d) AS w, "
               "extract(doy FROM d) AS dy, extract(week FROM d) AS wk, "
               "extract(quarter FROM d) AS q FROM t",
    "left_right": "SELECT LEFT(s, 2) AS l, RIGHT(s, 1) AS r, LEFT(s, 0) AS "
                  "z FROM t",
    "if": "SELECT if(x > 0, 'pos', 'neg') AS sign_text, if(k % 2 = 0, x, "
          "-x) AS flip, if(s IS NULL, 0, length(s)) AS n FROM t",
    "exists_array": "SELECT k, exists(sequence(0, k), v -> v > 3) AS big "
                    "FROM t",
    "exists_subquery": "SELECT k FROM t WHERE EXISTS (SELECT 1 FROM t "
                       "WHERE x > 5)",
    "lambdas": "SELECT transform(sequence(1, k), v -> v * x) AS tx, "
               "filter(sequence(0, k), v -> v % 2 = 0) AS ev, "
               "aggregate(sequence(1, k), 0, (acc, v) -> acc + v, "
               "acc -> acc * 10) AS ag FROM t",
    "builtins_by_name": "SELECT abs(x) AS a, round(x, 0) AS r, upper(s) "
                        "AS u, coalesce(s, 'none') AS c, greatest(x, k) "
                        "AS g, date_add(d, 1) AS da, hash(k, s) AS h, "
                        "substring_index(s, ' ', 1) AS si FROM t",
    "row_functions": "SELECT rand(7) AS r, randn(-3) AS n, "
                     "monotonically_increasing_id() AS id, "
                     "spark_partition_id() AS p, typeof(x) AS tx FROM t",
    "from_less": "SELECT 1 + 1, upper('a'), if(true, 1, 0), "
                 "to_date('2019-03-04') AS d, concat('a', 'b') || 'c'",
    "scalar_from_less": "SELECT k, x FROM t WHERE k > (SELECT 1 + 2)",
    "where_builtin": "SELECT k, s FROM t WHERE length(s) > 1 AND "
                     "instr(s, 'l') > 0 OR upper(s) = 'ZZ'",
    "aggregate_of_builtin": "SELECT band, round(avg(price), 2) AS ap, "
                            "max(length(band)) AS ml FROM banded GROUP BY "
                            "band ORDER BY band",
    "group_by_builtin": "SELECT pmod(guest, 3) AS g3, count(*) AS n FROM "
                        "banded GROUP BY pmod(guest, 3) ORDER BY g3",
}


@pytest.mark.parametrize("form", sorted(SQL_FORMS))
def test_sql_form_matches_jax(views, form):
    session, port = views
    sql = SQL_FORMS[form]
    assert_frames(port.sql(sql), session.sql(sql), 1e-9, ("ap",))


def test_exists_keeps_its_two_forms_apart(views):
    session, port = views
    for s in (session, port):
        assert s.sql("SELECT k FROM t WHERE EXISTS (SELECT 1 FROM t WHERE "
                     "x > 100)").count() == 0
        assert s.sql("SELECT k FROM t WHERE exists(sequence(0, k), v -> v "
                     "> 3)").count() == 2


def test_expr_builds_the_same_columns(views):
    session, port = views
    texts = ["round(price * 1.1, 1) AS r", "upper(band) AS u",
             "transform(sequence(1, 3), v -> v + guest) AS tx",
             "date_format(date_add(to_date('2019-01-01'), 3), 'dd/MM') AS d",
             "CAST(guest AS string) || band AS gb"]
    got = port.sql("SELECT * FROM banded").select(
        *[TF.expr(x) for x in texts])
    want = session.sql("SELECT * FROM banded").select(
        *[JF.expr(x) for x in texts])
    assert_frames(got, want)
    with pytest.raises(ValueError, match="scalar"):
        TF.expr("count(*)")


def test_unknown_function_in_sql_raises_the_registry_key_error(views):
    session, port = views
    for s in (session, port):
        with pytest.raises(KeyError):
            s.sql("SELECT no_such_function(k) FROM t").count()


def test_one_statement_mixing_the_families_on_dataset_full(views):
    """The slice as a whole: numbers, dates, strings, arrays with a
    lambda, hashes and JSON in one statement over dataset-full."""
    session, port = views
    sql = ("SELECT guest, band, round(price, 1) AS r, bround(price, 1) AS "
           "b, pmod(guest, 7) AS pm, sign(price - 100) AS sg, "
           "greatest(price, 50) AS gr, year(to_date('2019-01-01') + guest "
           "* 40) AS y, date_format(to_date('2019-12-25') + guest, "
           "'yyyy-MM-dd') AS ds, months_between(to_date('2020-01-31'), "
           "date_add(to_date('2019-01-01'), 3) + guest) AS mb, "
           "upper(band) || '-' || lpad(CAST(guest AS string), 3, '0') AS "
           "code, regexp_extract(CAST(price AS string), '(\\d+)\\.(\\d+)', "
           "1) AS whole, soundex(band) AS sx, transform(sequence(1, "
           "guest % 4 + 1), v -> v * 2) AS tx, aggregate(sequence(1, guest "
           "% 4 + 1), 0, (acc, v) -> acc + v) AS ag, hash(guest, price) AS "
           "h, xxhash64(band) AS xh, get_json_object(concat('{\"b\": \"', "
           "band, '\"}'), '$.b') AS jb FROM banded ORDER BY price, guest")
    assert_frames(port.sql(sql), session.sql(sql))


# ---------------------------------------------------------------------------
# The chip script's phase 12 on the CPU
# ---------------------------------------------------------------------------

def jax_hashes(guest, price, rows):
    """The JAX package's hashes of the first ``rows`` clean rows, on the
    CPU with x64 off (price as float32, as on the card)."""
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = jnp.float32
    try:
        with jax.enable_x64(False):
            keep = np.asarray(jax_dq_rules(jnp.asarray(price, jnp.float32),
                                           jnp.asarray(guest))[2])
            idx = np.flatnonzero(keep)[:rows]
            g = guest[idx]
            band = np.asarray(["small" if v < 10 else "medium" if v < 25
                               else "large" for v in g], dtype=object)
            f = JFrame({"guest": g, "price": price[idx], "band": band})
            h = np.asarray(JE.Func("hash", [JE.col("guest"), JE.col("price")]
                                   ).eval(f)).astype(int).tolist()
            xh = JE.Func("xxhash64", [JE.col("band")]).eval(f)
            cr = JE.Func("crc32", [JE.col("band")]).eval(f)
    finally:
        jax_config.default_float_dtype = old
    return {"rows": len(h), "hash_sum": sum(h), "hash_head": h[:5],
            "xxhash64_sum_mod64": sum(int(x) for x in xh) % (1 << 64),
            "crc32_sum": sum(int(x) for x in cr)}


def test_chip_smoke_hash_golden_is_the_jax_packages_output():
    guest, price = smoke.full_table(smoke.FULL_ROWS)
    n = smoke.BUILTIN_HASH_GOLDEN["rows"]
    want = jax_hashes(guest[:2 * n], price[:2 * n], n)
    assert smoke.BUILTIN_HASH_GOLDEN == want


def test_chip_smoke_builtins_phase_runs_on_the_cpu(monkeypatch):
    """Phase 12 at 30,000 rows on the CPU, with the head and small tables
    cut to 20,000 and 5,000 rows: the float32 run held to the CPU
    references through the phase's own comparison, its identities, the
    hashes against the JAX package's, the float64 timestamps."""
    monkeypatch.setattr(smoke, "BUILTIN_HEAD", 20_000)
    monkeypatch.setattr(smoke, "BUILTIN_SMALL", 5_000)
    guest, price = smoke.full_table(30_000)
    ref = smoke.builtin_reference(guest, price)
    with float_policy(torch.float32):
        spark, tables = smoke.builtin_tables("cpu", guest, price)
        outs = smoke.run_builtins(spark, tables, runs=2)
        first = smoke.first_runs(outs)
        card = smoke.summarize_builtins(first)
        again = smoke.summarize_builtins({k: v[1] for k, v in outs.items()})
        for key in card:
            assert smoke.differing(card[key], again[key]) == [], key
        errs = smoke.check_builtins(card, ref["cpu32"], ref["cpu64"])
        ids = smoke.check_builtin_identities(first, tables)
        hashes = smoke.builtin_hashes(first)
        spark.stop()
    default_catalog().clear()
    assert set(errs) == {f"numeric.{f}.{c}" for f in ("fluent", "sql")
                         for c in smoke.BUILTIN_TRANSCENDENTAL}
    assert max(errs.values()) < 1e-6
    assert ids["generator_rows"] > 5_000 and ids["drawn_slots"] == 30_000
    assert hashes == jax_hashes(guest, price, 5_000)
    stamps = ref["timestamps"]["ts.stamps"]
    assert len(stamps["ts"]) == 20_000


def test_chip_smoke_builtins_phase_catches_a_wrong_column():
    """The phase's comparison fails on one changed bit."""
    a = {"s.x": {"v": np.asarray([1.0, 2.0], np.float32), "t": ["a"]}}
    b = {"s.x": {"v": np.asarray([1.0, np.nextafter(np.float32(2),
                                                    np.float32(3))],
                                 np.float32), "t": ["a"]}}
    with pytest.raises(AssertionError, match="s.x.v"):
        smoke.check_builtins(a, b, b)
    assert smoke.differing(a["s.x"], b["s.x"]) == ["v"]
