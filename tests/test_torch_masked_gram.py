"""The masked augmented Gramian of the torch port (``ops/kernels.py:
masked_gram``, ``models/solvers.py:augmented_gram``,
``parallel/distributed.py:compute_gram``) on the CPU, where a CPU tensor
runs the plain version ``masked_gram_reference``. It is held against the
JAX package's ``augmented_gram`` within 1e-12 relative to ``|Z|ᵀ|Z|``,
elementwise: for boolean masks under ``config.pallas="interpret"`` (the
Pallas ``_gram_kernel`` body) and ``"off"`` (XLA), and for float weights
under ``"off"`` only, because the Pallas kernel's ``(Z·w)ᵀZ`` agrees with
XLA's ``(Z·w)ᵀ(Z·w)`` only for 0/1 weights and the port follows XLA. The
CUDA kernel itself is held against this plain version on the card by
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.models import solvers as jax_solvers
from sparkdq4ml_tpu.ops import pallas_kernels as jax_kernels
from sparkdq4ml_tpu.parallel import distributed as jax_dist
from sparkdq4ml_tpu_torch.models import solvers
from sparkdq4ml_tpu_torch.ops import kernels
from sparkdq4ml_tpu_torch.parallel import distributed


@pytest.fixture
def interpret():
    jax_config.pallas = "interpret"
    yield
    jax_config.pallas = "off"


def _inputs(n, d, seed, weights):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d) + rng.normal(
        size=d)
    y = X @ rng.normal(size=d) + 2.0 + rng.normal(scale=0.5, size=n)
    if weights == "bool":
        w = rng.random(n) > 0.25
    else:
        w = rng.uniform(0.0, 2.0, n) * (rng.random(n) > 0.25)
    return X, y, w


def _bound(X, y, w):
    Z = np.concatenate([X, y[:, None], np.ones((len(y), 1))], axis=1)
    Zw = np.abs(Z * np.asarray(w, np.float64)[:, None])
    return 1e-12 * (Zw.T @ Zw)


def _port(X, y, w):
    return kernels.masked_gram(torch.as_tensor(X), torch.as_tensor(y),
                               torch.as_tensor(w)).numpy()


SHAPES = [(1, 1), (40, 1), (jax_kernels.BLOCK_ROWS + 33, 1), (700, 3),
          (300, 16), (200, 128)]


@pytest.mark.parametrize("n,d", SHAPES)
def test_bool_mask_matches_pallas_interpret(interpret, n, d):
    X, y, w = _inputs(n, d, seed=n + d, weights="bool")
    ref = np.asarray(jax_solvers.augmented_gram(X, y, w))
    got = _port(X, y, w)
    assert got.shape == (d + 2, d + 2)
    assert np.all(np.abs(got - ref) <= _bound(X, y, w))


@pytest.mark.parametrize("weights", ["bool", "float"])
@pytest.mark.parametrize("n,d", SHAPES)
def test_matches_xla_augmented_gram(n, d, weights):
    X, y, w = _inputs(n, d, seed=3 * n + d, weights=weights)
    ref = np.asarray(jax_solvers.augmented_gram(X, y, w))
    got = _port(X, y, w)
    assert np.all(np.abs(got - ref) <= _bound(X, y, w))


def test_float_weights_follow_xla_not_pallas(interpret):
    """sqrt(w) weights, as the weighted Huber warm start passes them: the
    port squares the weight (XLA's contract); the Pallas kernel does not."""
    X, y, w = _inputs(200, 2, seed=5, weights="float")
    got = _port(X, y, w)
    pallas = np.asarray(jax_kernels.masked_gram_pallas(X, y, w))
    jax_config.pallas = "off"
    xla = np.asarray(jax_solvers.augmented_gram(X, y, w))
    assert np.all(np.abs(got - xla) <= _bound(X, y, w))
    assert np.abs(got - pallas).max() > 1e-3 * np.abs(xla).max()


def test_zero_rows(interpret):
    got = kernels.masked_gram(torch.zeros((0, 2), dtype=torch.float64),
                              torch.zeros(0, dtype=torch.float64),
                              torch.zeros(0, dtype=torch.bool))
    ref = np.asarray(jax_kernels.masked_gram_pallas(
        np.zeros((0, 2)), np.zeros(0), np.zeros(0, bool)))
    assert got.shape == (4, 4)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_float32_inputs_keep_their_dtype():
    X, y, w = _inputs(100, 2, seed=8, weights="float")
    got = kernels.masked_gram(torch.as_tensor(X, dtype=torch.float32),
                              torch.as_tensor(y, dtype=torch.float32),
                              torch.as_tensor(w, dtype=torch.float32))
    assert got.dtype == torch.float32
    ref = _port(X, y, w)
    assert np.all(np.abs(got.numpy() - ref) <= 1e-5 * 1e12 * _bound(X, y, w))


@pytest.mark.parametrize("weights", ["bool", "float"])
def test_augmented_gram_runs_the_plain_version_on_cpu(monkeypatch, weights):
    calls = []
    real = kernels.masked_gram_reference
    monkeypatch.setattr(kernels, "masked_gram_reference",
                        lambda X, y, w: calls.append(w.dtype)
                        or real(X, y, w))
    kernels.launches.reset()
    X, y, w = _inputs(50, 2, seed=2, weights=weights)
    A = solvers.augmented_gram(torch.as_tensor(X), torch.as_tensor(y),
                               torch.as_tensor(w))
    ref = np.asarray(jax_solvers.augmented_gram(X, y, w))
    assert np.all(np.abs(A.numpy() - ref) <= _bound(X, y, w))
    assert calls == [torch.bool if weights == "bool" else torch.float64]
    assert kernels.launches.snapshot()["masked_gram"] == 0


def test_compute_gram_matches_the_reference():
    X, y, w = _inputs(300, 3, seed=12, weights="bool")
    ref = np.asarray(jax_dist.compute_gram(X, y, w))
    got = distributed.compute_gram(torch.as_tensor(X), torch.as_tensor(y),
                                   torch.as_tensor(w)).numpy()
    assert np.all(np.abs(got - ref) <= _bound(X, y, w))
    # a 1-D feature column is one feature, as a (n, 1) matrix
    one = distributed.compute_gram(torch.as_tensor(X[:, 0]),
                                   torch.as_tensor(y), torch.as_tensor(w))
    ref1 = np.asarray(jax_dist.compute_gram(X[:, :1], y, w))
    assert np.all(np.abs(one.numpy() - ref1) <= _bound(X[:, :1], y, w))


def test_bad_inputs_raise():
    X = torch.ones((4, 2), dtype=torch.float64)
    y = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        kernels.masked_gram(X, y.float(), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="dtype"):
        kernels.masked_gram(X, y, torch.ones(4, dtype=torch.float32))
    with pytest.raises(ValueError, match="X must be"):
        kernels.masked_gram(X, y[:3], torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="X must be"):
        kernels.masked_gram(X[:, 0], y, torch.ones(4, dtype=torch.bool))


@pytest.mark.parametrize("n,d,elem", [(10_000_000, 1, 4), (1_000_000, 16, 4),
                                      (1_000_000, 128, 4),
                                      (1_000_000, 512, 4),
                                      (1_000_000, 512, 8), (1, 1, 8)])
def test_gram_plan_at_the_masked_shapes(n, d, elem):
    D = d + 2
    chunks, rows = kernels.gram_plan(n, D, elem)
    assert 1 <= chunks <= kernels.GRAM_MAX_CHUNKS
    assert chunks * rows >= n > (chunks - 1) * rows
    assert chunks == 1 or chunks * D * D * elem <= kernels.GRAM_PARTIAL_BYTES


@pytest.mark.parametrize("n", [1, 255, 10_007])
@pytest.mark.parametrize("d", [1, 3, 62, 128])
@pytest.mark.parametrize("weights", ["bool", "int"])
def test_gram_plan_reference_is_exact_on_the_masked_design(n, d, weights):
    """Zw = [X, y, 1]·w on integers, summed in the kernels' order (upper
    tiles, gram_plan's chunks, the chunk reduce, the mirror), equals the
    plain version exactly; one chunk up to GRAM_ONE_CHUNK_ROWS at D <= 4."""
    from test_torch_kernels import gram_plan_reference

    rng = np.random.default_rng(n + d)
    X = rng.integers(-8, 9, size=(n, d)).astype(np.float64)
    y = rng.integers(-8, 9, size=n).astype(np.float64)
    w = (rng.random(n) > 0.25 if weights == "bool"
         else rng.integers(0, 4, size=n).astype(np.float64))
    Zw = np.concatenate([X, y[:, None], np.ones((n, 1))], axis=1) * \
        np.asarray(w, np.float64)[:, None]
    A = gram_plan_reference(Zw)
    np.testing.assert_array_equal(A, _port(X, y, w))
    np.testing.assert_array_equal(A, A.T)
    chunks, _ = kernels.gram_plan(n, d + 2, 8)
    assert (chunks == 1) == (d + 2 <= kernels.GRAM_SMALL_MAX_D
                             and n <= kernels.GRAM_ONE_CHUNK_ROWS
                             or n <= kernels.GRAM_MIN_ROWS_PER_CHUNK)
