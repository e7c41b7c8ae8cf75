"""Recompute the goldens of ``chip_smoke.py``'s phase 18 from the JAX
package on the CPU, and print them as Python literals:

* ``PLANNER_EXPLAIN_GOLDEN``: plain ``EXPLAIN`` of each of
  ``PLANNER_ARMS`` on cold history over views of ``planner_tables()``
  (10^7 fact rows; EXPLAIN executes nothing);
* ``ADAPTIVE_GOLDEN``: the ``== Adaptive ==`` lines of
  ``drift_steps()`` over ``drift_tables()`` from the seed's snapshot.

Both with ``spark.audit.enabled=false``, ``spark.dq.profile.enabled=false``
and the float32 policy (x64 off), as on a TPU. Run from the root of a
checkout:

    JAX_PLATFORMS=cpu python tests/planner_goldens.py
"""

import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from sparkdq4ml_tpu.config import config  # noqa: E402
from sparkdq4ml_tpu.frame.frame import Frame  # noqa: E402
from sparkdq4ml_tpu.sql.parser import execute  # noqa: E402
from sparkdq4ml_tpu.utils import statstore  # noqa: E402


def register(tables: dict) -> None:
    for name, cols in tables.items():
        Frame(cols).create_or_replace_temp_view(name)


def explain_golden() -> dict:
    register(smoke.planner_tables())
    statstore.STORE.clear()
    out = {}
    for arm, sql, level in smoke.PLANNER_ARMS:
        config.optimizer_level = level
        out[arm] = execute("EXPLAIN " + sql).to_pydict()["plan"][0]
    config.optimizer_level = 1
    return out


def adaptive_golden() -> dict:
    register(smoke.drift_tables())
    statstore.STORE.clear()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "drift_seed.jsonl")
        jax.block_until_ready(execute(smoke.DRIFT_SEED_SQL)._mask)
        statstore.STORE.drain_pending()
        statstore.STORE.save(path, merge=False)

        def snapshot():
            statstore.STORE.clear()
            statstore.STORE.load(path)

        def set_aqe(on):
            config.aqe_enabled = on

        def sql(s):
            frame = execute(s)
            jax.block_until_ready(frame._mask)
            return frame

        def analyze(s):
            return execute("EXPLAIN ANALYZE " + s).to_pydict()["plan"][0]

        steps = smoke.drift_steps(sql, analyze, set_aqe, snapshot)
    config.aqe_enabled = True
    return {k: smoke.adaptive_lines(steps[k])
            for k in ("join_analyzed", "group_analyzed", "wide_analyzed")}


def main() -> None:
    config.audit_enabled = False
    config.dq_profile_enabled = False
    config.default_float_dtype = jnp.float32
    with jax.enable_x64(False):
        print("PLANNER_EXPLAIN_GOLDEN = " + repr(explain_golden()))
        print("ADAPTIVE_GOLDEN = " + repr(adaptive_golden()))


if __name__ == "__main__":
    main()
