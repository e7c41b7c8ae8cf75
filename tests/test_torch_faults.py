"""The port's fault injection (``sparkdq4ml_tpu_torch/utils/faults.py``)
against the JAX package's (``sparkdq4ml_tpu/utils/faults.py``), on the
CPU: the registry, plans parsed alike, schedules firing on the same
attempts, the same poisoned element, and a hook that costs one check
without a plan.
"""

import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.utils import faults as jf
from sparkdq4ml_tpu_torch.utils import faults as tf

SPECS = (
    "pipeline_flush:device_error:1",
    "gram_sharded:device_error:1,2;solver:nan:1",
    "fit:preempt:p=0.25:seed=7;mesh:device_drop:n=2",
    "oom:oom:n=65536",
    "ingest_native:torn_chunk:2,5\ningest_native:thread_death:p=0.5",
    "aqe:stall:p=0.3;aqe:device_error:3",
)


@pytest.fixture(autouse=True)
def no_plan():
    jf.clear()
    tf.clear()
    yield
    jf.clear()
    tf.clear()


def _fields(spec) -> tuple:
    return (spec.site, spec.kind, spec.attempts, spec.p, spec.n, spec.seed)


def test_registry_and_kinds_are_the_jax_packages():
    assert tf.FAULT_SITES == jf.FAULT_SITES
    assert tf.KINDS == jf.KINDS


@pytest.mark.parametrize("text", SPECS)
def test_plans_parse_alike(text):
    a, b = jf.parse_plan(text, seed=3), tf.parse_plan(text, seed=3)
    assert [_fields(s) for s in a.specs] == [_fields(s) for s in b.specs]
    assert a.seed == b.seed


@pytest.mark.parametrize("bad", ("solo", "site:nokind"))
def test_bad_specs_raise_alike(bad):
    with pytest.raises(ValueError):
        jf.parse_spec(bad)
    with pytest.raises(ValueError):
        tf.parse_spec(bad)


@pytest.mark.parametrize("seed", (0, 7, 123456))
def test_det_uniform_is_the_same_draw(seed):
    for site in ("fit", "pipeline_flush#leaf", "aqe"):
        for attempt in range(1, 300):
            assert tf._det_uniform(seed, site, attempt) == \
                jf._det_uniform(seed, site, attempt)


@pytest.mark.parametrize("text", SPECS)
@pytest.mark.parametrize("seed", (0, 11))
def test_schedules_fire_on_the_same_attempts(text, seed):
    """The same calls of every hook under one plan in each package: the
    same fire records, the same raises and the same budgets."""
    def drive(mod):
        out = []
        with mod.inject_faults(*[s for s in text.replace("\n", ";")
                                 .split(";") if s], seed=seed) as plan:
            for _ in range(40):
                for site in ("pipeline_flush", "gram_sharded", "solver",
                             "fit", "aqe", "ingest_native"):
                    try:
                        mod.inject(site)
                        out.append("ok")
                    except Exception as e:
                        out.append(type(e).__name__)
                    for kind in ("stall", "torn_chunk", "thread_death"):
                        out.append(mod.fired(site, kind))
                out.append(mod.shrunk_budget("oom"))
                leaf = [1.5]
                out.append(mod.corrupt("solver", leaf) is leaf)
            return out, plan.fired
    assert drive(tf) == drive(jf)


def _tree(mod):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, 4))
    b = rng.normal(size=7)
    c = rng.normal(size=2)
    if mod is tf:
        return {"b": torch.tensor(b), "a": a,
                "z": (np.int32(3), torch.tensor(c)), "n": None}
    import jax.numpy as jnp

    return {"b": jnp.asarray(b), "a": a, "z": (np.int32(3), jnp.asarray(c)),
            "n": None}


def _nan_positions(tree) -> list:
    out = []
    for key in ("a", "b"):
        out.append(np.flatnonzero(np.isnan(np.asarray(tree[key]))).tolist())
    out.append(np.flatnonzero(np.isnan(np.asarray(tree["z"][1]))).tolist())
    return out


@pytest.mark.parametrize("seed", range(12))
def test_corrupt_poisons_the_same_element(seed):
    """Dict keys sorted, as jax.tree_util flattens them: the same leaf and
    element, whatever the key order of the dict."""
    with jf.inject_faults("solver:nan:1", seed=seed):
        j = jf.corrupt("solver", _tree(jf))
    with tf.inject_faults("solver:nan:1", seed=seed):
        t = tf.corrupt("solver", _tree(tf))
    assert _nan_positions(t) == _nan_positions(j)
    assert sum(len(p) for p in _nan_positions(t)) == 1
    assert isinstance(t["b"], torch.Tensor) and t["n"] is None
    assert isinstance(t["z"], tuple) and t["z"][0] == 3


def test_corrupt_keeps_a_namedtuple_and_skips_ints():
    from sparkdq4ml_tpu_torch.models.solvers import FitResult

    r = FitResult(np.ones(2), np.float64(1.0), np.int32(4), np.ones(5),
                  True)
    with tf.inject_faults("solver:nan:1", seed=2):
        out = tf.corrupt("solver", r)
    assert type(out) is FitResult and out.iterations == 4
    assert sum(int(np.isnan(np.asarray(v)).sum())
               for v in (out.coefficients, out.intercept,
                         out.objective_history)) == 1


def test_injected_device_error_is_the_cards_class():
    assert issubclass(tf.InjectedDeviceError, torch.AcceleratorError)
    assert not issubclass(tf.Preemption, torch.AcceleratorError)
    with tf.inject_faults("fit:device_error:1"):
        with pytest.raises(torch.AcceleratorError):
            tf.inject("fit")
    with tf.inject_faults("fit:io_error:1"):
        with pytest.raises(OSError) as info:
            tf.inject("fit")
        assert not isinstance(info.value, FileNotFoundError)


def test_no_plan_costs_one_check(monkeypatch):
    """Without a plan no hook reaches the plan's machinery."""
    def boom(*a, **k):
        raise AssertionError("the fault machinery ran without a plan")

    monkeypatch.setattr(tf.FaultPlan, "_tick", boom)
    monkeypatch.setattr(tf, "_poison", boom)
    tree = {"x": torch.ones(3)}
    for site in tf.FAULT_SITES:
        tf.inject(site)
        assert tf.fired(site, "stall") is False
        assert tf.shrunk_budget(site) is None
        assert tf.corrupt(site, tree) is tree


def test_env_schedule_installs_once(monkeypatch):
    monkeypatch.setenv(tf.ENV_VAR, "aqe:device_error:2")
    monkeypatch.setattr(tf, "_ENV_CHECKED", False)
    monkeypatch.setattr(tf, "_PLAN", None)
    plan = tf.active()
    assert [_fields(s) for s in plan.specs] == \
        [("aqe", "device_error", frozenset({2}), None, 1, None)]
    tf.inject("aqe")
    with pytest.raises(tf.InjectedDeviceError):
        tf.inject("aqe")
    assert plan.fired == [("aqe", "device_error", 2)]
    assert plan.attempts_at("aqe") == 2


@pytest.mark.parametrize("real", [
    None,
    torch.AcceleratorError("CUDA error: an illegal memory access"),
    torch.OutOfMemoryError("CUDA out of memory"),
])
def test_only_an_injected_fault_moves_a_grouped_op_to_the_host(monkeypatch,
                                                               real):
    """The ``grouped_flush`` ladder: an injected fault at the op's entry
    degrades it to the host lowering with its recovery event; a real
    device fault or out-of-memory of the grouped program raises, with no
    event, and never reruns the op on the host."""
    from sparkdq4ml_tpu_torch import TorchSession
    from sparkdq4ml_tpu_torch.frame import aggregates as TA
    from sparkdq4ml_tpu_torch.ops import segments
    from sparkdq4ml_tpu_torch.utils.recovery import RECOVERY_LOG

    run = segments._run_grouping
    hosts = []

    def grouping(*args):
        hosts.append(args[-1])
        if real is not None and not args[-1]:
            raise real
        return run(*args)

    monkeypatch.setattr(segments, "_run_grouping", grouping)
    RECOVERY_LOG.clear()
    spark = TorchSession.builder().config("spark.torch.device",
                                          "cpu").get_or_create()
    try:
        df = spark.create_data_frame({"k": np.array([1, 2, 1, 3]),
                                      "v": np.arange(4.0)})
        if real is None:
            with tf.inject_faults("grouped_flush:device_error:1"):
                out = df.group_by("k").agg(TA.sum("v").alias("s"))
            got = {k: list(map(float, v))
                   for k, v in out.to_pydict().items()}
            assert got == {"k": [1.0, 2.0, 3.0], "s": [2.0, 1.0, 3.0]}
            assert hosts == [True]
            assert [(e.site, e.action, e.rung)
                    for e in RECOVERY_LOG.events()] == [
                ("grouped_flush", "fallback", "host")]
        else:
            with pytest.raises(type(real)) as got:
                df.group_by("k").agg(TA.sum("v").alias("s"))
            assert got.value is real and hosts == [False]
            assert RECOVERY_LOG.events() == []
    finally:
        spark.stop()
        RECOVERY_LOG.clear()
