"""The torch port's DQ rules (``sparkdq4ml_tpu_torch/ops/rules.py``) held
against the JAX package's, on the same seeded inputs, in float64.

The JAX fused chain runs both ways its own tests run it on the CPU: plain
XLA (``config.pallas = "off"``) and the Pallas kernel body through the
interpreter (``"interpret"``). On the CPU the port's ``dq_rules_fused``
runs the plain version of its CUDA kernel. Rule columns and keep masks
must agree bit for bit, NaN positions included.
"""

import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.ops import pallas_kernels as jax_kernels
from sparkdq4ml_tpu.ops import rules as jax_rules
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.ops import rules
from sparkdq4ml_tpu_torch.ops.udf import UDFRegistry

MULTI_TILE = jax_kernels.DQ_BLOCK_ROWS * 128 + 777


@pytest.fixture(autouse=True)
def _float64():
    with float_policy(torch.float64):
        yield


@pytest.fixture(params=["off", "interpret"])
def pallas_mode(request):
    jax_config.pallas = request.param
    yield request.param
    jax_config.pallas = "off"


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    price = rng.uniform(0.0, 130.0, n)
    guest = rng.integers(1, 40, n).astype(np.float64)
    price[rng.random(n) < 0.05] = np.nan
    guest[rng.random(n) < 0.05] = np.nan
    return price, guest


def _bits(a):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.view(np.int64 if a.itemsize == 8 else np.int32)
    return a


def _assert_same(port, ref):
    for p, r in zip(port, ref):
        p = p.numpy()
        r = np.asarray(r)
        assert p.dtype == r.dtype and p.shape == r.shape
        np.testing.assert_array_equal(_bits(p), _bits(r))


@pytest.mark.parametrize("n", [1, 127, 128, 1000, MULTI_TILE])
def test_fused_chain_matches_jax(pallas_mode, n):
    price, guest = _inputs(n, seed=n)
    ref = jax_rules.dq_rules_fused(price, guest)
    port = rules.dq_rules_fused(torch.as_tensor(price),
                                torch.as_tensor(guest))
    _assert_same(port, ref)


def test_fused_chain_zero_rows():
    """n = 0 gives empty outputs (the JAX chain with pallas='off'; the
    reference's Pallas path cannot take n = 0, see ROADMAP C)."""
    ref = jax_rules.dq_rules_fused(np.zeros(0), np.zeros(0))
    port = rules.dq_rules_fused(torch.zeros(0, dtype=torch.float64),
                                torch.zeros(0, dtype=torch.float64))
    _assert_same(port, ref)
    assert all(t.shape == (0,) for t in port)


@pytest.mark.parametrize("n", [1, 128, 1000])
def test_single_rules_match_jax(n):
    price, guest = _inputs(n, seed=100 + n)
    np.testing.assert_array_equal(
        _bits(rules.minimum_price_rule(torch.as_tensor(price)).numpy()),
        _bits(jax_rules.minimum_price_rule(price)))
    np.testing.assert_array_equal(
        _bits(rules.price_correlation_rule(torch.as_tensor(price),
                                           torch.as_tensor(guest)).numpy()),
        _bits(jax_rules.price_correlation_rule(price, guest)))


def test_nan_asymmetry(pallas_mode):
    """Rule 1 lets a NaN price through; rule 2 maps NaN in either input to
    the sentinel; both rows leave the keep mask."""
    price = np.array([np.nan, 50.0, 50.0, 19.0, 95.0, 95.0])
    guest = np.array([20.0, np.nan, 20.0, 20.0, 13.0, 14.0])
    pnm, pcc, keep = rules.dq_rules_fused(torch.as_tensor(price),
                                          torch.as_tensor(guest))
    assert np.isnan(pnm[0].item())
    assert pcc[0].item() == -1.0 and pcc[1].item() == -1.0
    assert pnm[3].item() == -1.0 and pcc[4].item() == -1.0
    assert keep.tolist() == [False, False, True, False, False, True]
    _assert_same((pnm, pcc, keep), jax_rules.dq_rules_fused(price, guest))


def test_int_inputs_cast_to_float_first(pallas_mode):
    rng = np.random.default_rng(5)
    price = rng.integers(0, 130, 300).astype(np.int32)
    guest = rng.integers(1, 40, 300).astype(np.int32)
    ref = jax_rules.dq_rules_fused(price, guest)
    port = rules.dq_rules_fused(torch.as_tensor(price),
                                torch.as_tensor(guest))
    assert port[0].dtype == torch.float64
    _assert_same(port, ref)


def test_float32_policy_matches_jax_float32(pallas_mode):
    import jax.numpy as jnp

    price, guest = _inputs(500, seed=9)
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = jnp.float32
    try:
        ref = jax_rules.dq_rules_fused(price, guest)
    finally:
        jax_config.default_float_dtype = old
    with float_policy(torch.float32):
        port = rules.dq_rules_fused(torch.as_tensor(price),
                                    torch.as_tensor(guest))
    assert port[0].dtype == torch.float32
    _assert_same(port, ref)


@pytest.mark.parametrize("name,n_clean", [("abstract", 24), ("small", 20),
                                          ("full", 1024)])
def test_golden_keep_counts(name, n_clean):
    from conftest import dataset_path
    from sparkdq4ml_tpu_torch.frame.csv import read_csv

    df = read_csv(dataset_path(name), device="cpu")
    _, _, keep = rules.dq_rules_fused(df._column_values("_c1"),
                                      df._column_values("_c0"))
    assert int(keep.sum()) == n_clean


def test_register_builtin_rules():
    reg = UDFRegistry()
    rules.register_builtin_rules(reg)
    assert reg.names() == ["minimumPriceRule", "priceCorrelationRule"]
    fn, dtype = reg.lookup("minimumPriceRule")
    assert fn is rules.minimum_price_rule and dtype == torch.float64


def test_constants_match_reference():
    assert (rules.MIN_PRICE, rules.CORRELATION_MAX_GUESTS,
            rules.CORRELATION_MAX_PRICE, rules.BAD_ROW_SENTINEL) == (
        jax_rules.MIN_PRICE, jax_rules.CORRELATION_MAX_GUESTS,
        jax_rules.CORRELATION_MAX_PRICE, jax_rules.BAD_ROW_SENTINEL)
