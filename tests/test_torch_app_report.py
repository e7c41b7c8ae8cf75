"""``python -m sparkdq4ml_tpu_torch.app`` (``sparkdq4ml_tpu_torch/app.py``)
against the JAX package's ``examples/dq4ml_pipeline.py``, both run here on
the CPU in float32 (the JAX side under ``jax.enable_x64(False)``), from
a fresh plan cache and fresh counters as in a new process, on the three
reference datasets, with their standard output captured.

Every printed line is equal: the banners, the schemas, the tables, the
summary, the prediction and the last line, ``pipeline counters: {...}``.
Numbers are held within rtol 1e-5 / atol 1e-4 (the two float32 fits sum in
different orders; the golden envelope of the float32 app is 1e-3), and
the column widths and borders they set are not compared. Of the
wall-clock line, its label and its phases are compared, not its times.
"""

import ast
import contextlib
import io
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import dataset_path
from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.ops import compiler as jax_compiler
from sparkdq4ml_tpu.utils.profiling import counters as jax_counters
from sparkdq4ml_tpu_torch import TorchSession, app
from sparkdq4ml_tpu_torch.ops import compiler
from sparkdq4ml_tpu_torch.sql import default_catalog
from sparkdq4ml_tpu_torch.utils.profiling import counters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?")
WALL = "phase wall-clock (s, cold = first run incl. XLA compile):"
LAST = ("pipeline counters: {'pipeline.flush': 9, 'pipeline.compile': 3, "
        "'pipeline.hit': 6}")
RTOL, ATOL = 1e-5, 1e-4


def _example():
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import dq4ml_pipeline
    finally:
        sys.path.pop(0)
    return dq4ml_pipeline


def _captured(fn) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def _jax_lines(path):
    from sparkdq4ml_tpu import TpuSession

    saved = jax_config.default_float_dtype
    jax_config.default_float_dtype = jnp.float32
    jax_compiler.clear_cache()
    jax_counters.clear()
    try:
        with jax.enable_x64(False):
            return _captured(lambda: _example().start(path))
    finally:
        jax_config.default_float_dtype = saved
        active = TpuSession.active()
        if active is not None:
            active.stop()


def _port_lines(path):
    compiler.clear_cache()
    counters.clear()
    try:
        return _captured(lambda: app.start(path, "cpu"))
    finally:
        s = TorchSession.active()
        if s is not None:
            s.stop()
        default_catalog().clear()


def _shape(line: str) -> str:
    """The line with its numbers taken out and its padding and border
    widths collapsed."""
    return re.sub(r"-+", "-", re.sub(r"\s+", "", NUMBER.sub("#", line)))


@pytest.mark.parametrize("name", ["abstract", "small", "full"])
def test_app_prints_what_the_jax_example_prints(name):
    path = dataset_path(name)
    want = _jax_lines(path)
    got = _port_lines(path)
    assert len(got) == len(want)
    assert got[-1] == want[-1] == LAST
    for i, (g, w) in enumerate(zip(got, want)):
        if w.startswith(WALL):
            assert g.startswith(WALL)
            gd = ast.literal_eval(g[len(WALL):].strip())
            wd = ast.literal_eval(w[len(WALL):].strip())
            assert list(gd) == list(wd) == ["load", "dq_rules", "fit"]
            assert all(set(v) == {"cold", "steady"} for v in gd.values())
            continue
        assert _shape(g) == _shape(w), (i, g, w)
        gn = [float(x) for x in NUMBER.findall(g)]
        wn = [float(x) for x in NUMBER.findall(w)]
        np.testing.assert_allclose(gn, wn, rtol=RTOL, atol=ATOL,
                                   err_msg=f"line {i}: {g!r} vs {w!r}")


def test_main_parses_its_arguments(monkeypatch):
    seen = []
    monkeypatch.setattr(app, "start", lambda *a: seen.append(a))
    app.main(["data/x.csv", "--device", "cpu"])
    app.main([])
    assert seen[0] == ("data/x.csv", "cpu")
    assert seen[1][0].endswith(os.path.join("data", "dataset-abstract.csv"))
    assert seen[1][1] is None


def _smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def test_app_report_golden_is_the_jax_examples_last_line():
    smoke = _smoke()
    assert set(smoke.APP_REPORT_GOLDEN) == set(smoke.GOLDEN)
    assert set(smoke.APP_REPORT_GOLDEN.values()) == {LAST}


def test_chip_smoke_defines_each_name_once():
    """A later definition of a module-level name would replace an earlier
    phase's helper for the whole script."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert sorted({n for n in names if names.count(n) > 1}) == []


def test_chip_smoke_phase_17_checks_run_on_the_cpu():
    """Phase 17(c)'s checks at 1,040 rows on the CPU: the app path with
    the pipeline on against off bit for bit, one plan at two literals in
    turns against eager, and a planted difference found."""
    import sparkdq4ml_tpu_torch as dq

    smoke = _smoke()
    compiler.clear_cache()
    guest, price = smoke.full_table(smoke.PIPELINE_SMALL_ROWS, seed=1)
    spark = smoke.session("cpu")
    try:
        df = spark.create_data_frame({"guest": guest, "price": price})
        res = smoke.app_on_off(spark, df, "(c)")
        assert res[True]["counts"] == res[False]["counts"]
        assert res[True]["stats"] and not res[False]["stats"]
        d1 = df.with_column("price_no_min", dq.call_udf(
            "minimumPriceRule", df.col("price")))
        d1.create_or_replace_temp_view("price")
        clean = spark.sql(smoke.RULE_1_SQL)
        turns = smoke.literal_turns(spark, d1)
        assert (turns["compiles"], turns["hits"]) == (0, 4)
        assert turns["kept"][0] == clean.count() > turns["kept"][50]
        bumped = clean.with_column("price", dq.col("price") + 1.0)
        assert smoke.frame_differences(clean, bumped) == ["price"]
        assert smoke.frame_differences(clean, clean.filter(
            dq.col("price") > 50)) == ["mask"]
    finally:
        spark.stop()
        default_catalog().clear()
