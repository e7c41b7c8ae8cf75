"""Helpers of the planner parity tests (``tests/test_torch_optimizer.py``,
``_aqe.py``, ``_explain.py``, ``_costprof.py``): the JAX package and the
port under one float policy and one set of planner settings, the same
seeded numpy frames registered as views in both catalogs, each statement
run through both packages' ``execute``, and the comparisons.

The JAX side runs with ``spark.audit.enabled=false`` (its ``est peak``
column is not in the port), and both with
``spark.dq.profile.enabled=false``, so that neither's recorded flush
costs include sketches (``tests/test_torch_dqprof.py`` holds the
observatory's EXPLAIN section). Float policies: ``float64`` runs the
JAX side with x64 on and the port at one intra-op thread; ``float32``
with x64 off, as on a TPU.
"""

import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_repro import one_intra_op_thread

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.ops import compiler as jax_compiler
from sparkdq4ml_tpu.ops import segments as jax_segments
from sparkdq4ml_tpu.sql import parser as jax_parser
from sparkdq4ml_tpu.utils import observability as jax_obs
from sparkdq4ml_tpu.utils import statstore as jax_statstore
from sparkdq4ml_tpu.utils.profiling import counters as jax_counters
from sparkdq4ml_tpu_torch import TorchSession
from sparkdq4ml_tpu_torch.config import config, float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import compiler, kernels, segments
from sparkdq4ml_tpu_torch.sql import default_catalog, parser
from sparkdq4ml_tpu_torch.utils import costprof
from sparkdq4ml_tpu_torch.utils import observability as obs
from sparkdq4ml_tpu_torch.utils import statstore
from sparkdq4ml_tpu_torch.utils.profiling import counters

#: The settings both packages share, saved and restored by ``planner``.
SHARED = ("optimizer_enabled", "optimizer_level", "aqe_enabled",
          "aqe_drift_factor", "audit_device_budget", "explain_memory",
          "explain_caches", "costprof_enabled", "pipeline",
          "dq_profile_enabled")
JAX_ONLY = ("audit_enabled", "default_float_dtype")


def reset() -> None:
    default_catalog().clear()
    for c in (compiler, jax_compiler, segments, jax_segments):
        c.clear_cache()
    for cnt in (counters, jax_counters):
        cnt.clear()
    statstore.STORE.clear()
    jax_statstore.STORE.clear()
    costprof.clear()
    kernels.last_call.clear()
    obs.disable()
    obs.reset()
    jax_obs.disable()
    jax_obs.reset()


@contextlib.contextmanager
def planner(policy: str = "float64"):
    """Both packages under ``policy`` with the planner at its defaults,
    fresh caches, counters and statstores, and a port session on the
    CPU (the plan frames of EXPLAIN take its device)."""
    saved = ({a: getattr(config, a) for a in SHARED},
             {a: getattr(jax_config, a) for a in SHARED + JAX_ONLY})
    jax_config.audit_enabled = False
    jax_config.default_float_dtype = getattr(jnp, policy)
    for cfg in (config, jax_config):
        cfg.dq_profile_enabled = False
        cfg.optimizer_enabled = True
        cfg.optimizer_level = 1
        cfg.aqe_enabled = True
        cfg.aqe_drift_factor = 4.0
        cfg.audit_device_budget = 0
        cfg.explain_memory = True
        cfg.explain_caches = True
        cfg.costprof_enabled = True
        cfg.pipeline = True
    reset()
    session = TorchSession.builder().config("spark.torch.device",
                                            "cpu").get_or_create()
    try:
        with jax.enable_x64(policy == "float64"), \
                float_policy(getattr(torch, policy)), \
                (one_intra_op_thread() if policy == "float64"
                 else contextlib.nullcontext()):
            yield session
    finally:
        session.stop()
        for a, v in saved[0].items():
            setattr(config, a, v)
        for a, v in saved[1].items():
            setattr(jax_config, a, v)
        reset()


@pytest.fixture(params=("float64", "float32"))
def both(request):
    with planner(request.param) as session:
        yield session


@pytest.fixture
def both64():
    with planner("float64") as session:
        yield session


def setting(**kw) -> None:
    """One setting in both packages (``optimizer_level=2``, ...)."""
    for cfg in (config, jax_config):
        for k, v in kw.items():
            setattr(cfg, k, v)


def register(name: str, cols: dict) -> None:
    """``cols`` as the view ``name`` in both catalogs."""
    JFrame({k: np.array(v, copy=True) for k, v in cols.items()}
           ).create_or_replace_temp_view(name)
    TFrame({k: np.array(v, copy=True) for k, v in cols.items()},
           device="cpu").create_or_replace_temp_view(name)


def suite_views(n: int = 4000, seed: int = 3) -> None:
    """The JAX optimizer suite's relations: a fact table, a full dim, a
    partial dim (64 of 128 keys)."""
    rng = np.random.default_rng(seed)
    register("big", {"k": rng.integers(0, 128, n).astype(np.float64),
                     "v": rng.normal(size=n), "x1": rng.normal(size=n),
                     "x2": rng.normal(size=n)})
    register("mid", {"k": np.arange(128).astype(np.float64),
                     "u": rng.normal(size=128)})
    register("small", {"k": np.arange(64).astype(np.float64),
                       "w": rng.normal(size=64)})


def jax_run(sql: str) -> dict:
    return jax_parser.execute(sql).to_pydict()


def port_run(sql: str) -> dict:
    return parser.execute(sql).to_pydict()


def plan(sql: str) -> tuple:
    """``(jax_text, port_text)`` of ``sql`` (an EXPLAIN statement)."""
    return jax_run(sql)["plan"][0], port_run(sql)["plan"][0]


def _arr(v) -> np.ndarray:
    a = np.asarray(v)
    return a.astype(np.float64) if a.dtype != object else a


def assert_exact(a: dict, b: dict) -> None:
    """Equal column names in order and equal values (NaN equal NaN)."""
    assert list(a) == list(b)
    for c in a:
        x, y = _arr(a[c]), _arr(b[c])
        assert x.shape == y.shape, c
        if x.dtype == object:
            assert list(x) == list(y), c
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"column {c!r}")


def assert_sorted(a: dict, b: dict) -> None:
    """Equal as sorted rows (the level-2 reorder's contract)."""
    assert sorted(a) == sorted(b)
    cols = sorted(a)
    x = np.array([_arr(a[c]) for c in cols])
    y = np.array([_arr(b[c]) for c in cols])
    assert x.shape == y.shape
    np.testing.assert_array_equal(x[:, np.lexsort(x[::-1])],
                                  y[:, np.lexsort(y[::-1])])


def sections(text: str) -> list:
    """The ``== ... ==`` headers of an EXPLAIN text, in order."""
    return [ln for ln in text.splitlines() if re.fullmatch(r"== .+ ==", ln)]


def section(text: str, name: str) -> list:
    """The lines of the section ``== name ==``."""
    lines = text.splitlines()
    start = lines.index(f"== {name} ==") + 1
    out = []
    for ln in lines[start:]:
        if re.fullmatch(r"== .+ ==", ln):
            break
        out.append(ln)
    return out


#: The node fields held equal between the packages in an ANALYZE tree.
STRUCTURAL = ("rows_in", "rows_out", "compile", "rows_valid", "est_rows")


def analyzed_nodes(text: str) -> list:
    """``[(label with its indent, {field: value})]`` of the analyzed plan,
    the structural fields only."""
    out = []
    for ln in section(text, "Analyzed Plan"):
        label, _, rest = ln.partition("  (")
        fields = dict(re.findall(r"(\w+)=(\S+)", rest.rstrip(")")))
        out.append((label, {k: fields.get(k) for k in STRUCTURAL}))
    return out


def assert_same_analysis(jax_text: str, port_text: str) -> None:
    """The same tree, row counts, verdicts, sections and section order;
    the rewrite, before-optimization and adaptive sections line for
    line."""
    assert sections(jax_text) == sections(port_text)
    assert analyzed_nodes(jax_text) == analyzed_nodes(port_text)
    for name in ("Rewrites", "Before Optimization", "Adaptive"):
        if f"== {name} ==" in jax_text:
            assert section(jax_text, name) == section(port_text, name)
