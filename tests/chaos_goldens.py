"""Recompute ``chip_smoke.CHAOS_GOLDEN`` from the JAX package on the CPU
and print it as a Python literal: for each of ``chip_smoke.CHAOS_SCHEDULES``
the recovery events ``[site, action, rung, attempt]`` of
``chip_smoke.chaos_app`` on dataset-abstract under that schedule (seed
``CHAOS_SEED``), and the clean run's row count, GROUP BY sum, coefficient
and RMSE. The float32 policy (x64 off), as on a TPU, with
``spark.audit.enabled=false``. Run from the root of a checkout:

    JAX_PLATFORMS=cpu python tests/chaos_goldens.py
"""

import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
import sparkdq4ml_tpu as dq  # noqa: E402
from sparkdq4ml_tpu import models, sql  # noqa: E402
from sparkdq4ml_tpu.config import config  # noqa: E402
from sparkdq4ml_tpu.ops import compiler, segments  # noqa: E402
from sparkdq4ml_tpu.utils import (costprof, dqprof, faults,  # noqa: E402
                                  recovery, statstore)
from sparkdq4ml_tpu.utils.profiling import counters  # noqa: E402

ABSTRACT = os.path.join(ROOT, "data", "dataset-abstract.csv")


def fresh_jax_state() -> None:
    """``chip_smoke.fresh_chaos_state`` of the JAX package."""
    compiler.clear_cache()
    segments.clear_cache()
    statstore.STORE.clear()
    dqprof.clear()
    costprof.clear()
    recovery.RECOVERY_LOG.clear()
    recovery.DEVICE_BREAKER.reset()
    faults.clear()
    sql.default_catalog().clear()
    counters.clear("recovery.")
    counters.clear("faults.")


def jax_chaos_run(schedule, frame_of, tmp: str) -> tuple:
    """``chip_smoke.chaos_run`` of the JAX package, with
    ``spark.audit.enabled=false``."""
    saved = config.audit_enabled
    config.audit_enabled = False
    try:
        fresh_jax_state()
        spark = smoke.chaos_session(dq.TpuSession.builder(), schedule, tmp)
        return smoke.chaos_drive(dq, models, spark, frame_of,
                                 faults.active(), recovery.RECOVERY_LOG)
    finally:
        config.audit_enabled = saved


def jax_run(schedule, tmp: str) -> tuple:
    """:func:`jax_chaos_run` on dataset-abstract."""
    return jax_chaos_run(schedule, smoke.csv_frame(ABSTRACT), tmp)


def chaos_golden() -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        clean = jax_run(None, tmp)[0]
        events = {s: jax_run(s, tmp)[1] for s in smoke.CHAOS_SCHEDULES}
    return {"clean": {k: clean[k] for k in ("rows", "group_sum", "coef",
                                            "rmse")},
            "events": events}


def literal(golden: dict) -> str:
    """``CHAOS_GOLDEN = {...}``, one event a line."""
    lines = ["CHAOS_GOLDEN = {", "    'clean': {"]
    lines += [f"        {k!r}: {v!r}," for k, v in golden["clean"].items()]
    lines += ["    },", "    'events': {"]
    for schedule, events in golden["events"].items():
        if not events:
            lines.append(f"        {schedule!r}: [],")
            continue
        lines.append(f"        {schedule!r}: [")
        lines += [f"            {ev!r}," for ev in events]
        lines.append("        ],")
    return "\n".join(lines + ["    },", "}"])


if __name__ == "__main__":
    print(literal(chaos_golden()))
