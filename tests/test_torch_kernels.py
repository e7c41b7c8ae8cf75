"""The kernel module of the torch port (``sparkdq4ml_tpu_torch/ops/
kernels.py``) on the CPU: it imports without ``nvcc``, a CPU tensor runs
the plain version of each kernel (and counts no launch), and the plain
Gramian agrees with the JAX package's Pallas kernel (interpret mode) and
with ``Z.T @ Z`` within 1e-12 relative to ``|Z|ᵀ|Z|``, elementwise (the
scale of each sum of products, so that entries that cancel to near zero
are held to the same precision as the rest). The CUDA kernels themselves
are held against these plain versions on the card by ``chip_smoke.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.ops import pallas_kernels as jax_kernels
from sparkdq4ml_tpu.parallel.distributed import pack_design as jax_pack
from sparkdq4ml_tpu_torch.ops import kernels


@pytest.fixture
def interpret():
    jax_config.pallas = "interpret"
    yield
    jax_config.pallas = "off"


def _design(n, D, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(jax_pack(rng.normal(size=(n, D - 2)),
                               rng.normal(size=n), rng.random(n) > 0.25))


@pytest.mark.parametrize("n,D", [(1, 3), (40, 3), (jax_kernels.BLOCK_ROWS + 33,
                                                   3), (700, 18), (300, 130)])
def test_packed_gram_matches_pallas_interpret(interpret, n, D):
    Z = _design(n, D, seed=n + D)
    ref = np.asarray(jax_kernels.packed_gram_pallas(Z))
    got = kernels.packed_gram(torch.as_tensor(Z)).numpy()
    scale = 1e-12 * (np.abs(Z).T @ np.abs(Z))
    assert np.all(np.abs(got - ref) <= scale)
    assert np.all(np.abs(got - Z.T @ Z) <= scale)


def test_packed_gram_zero_rows(interpret):
    got = kernels.packed_gram(torch.zeros((0, 3), dtype=torch.float64))
    ref = np.asarray(jax_kernels.packed_gram_pallas(np.zeros((0, 3))))
    assert got.shape == (3, 3)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_dq_rules_reference_matches_pallas_interpret(interpret):
    rng = np.random.default_rng(3)
    n = 1000
    price = rng.uniform(0, 130, n)
    guest = rng.integers(1, 40, n).astype(np.float64)
    price[::37] = np.nan
    guest[::41] = np.nan
    ref = jax_kernels.dq_rules_pallas(price, guest)
    got = kernels.dq_rules(torch.as_tensor(price), torch.as_tensor(guest))
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        if g.dtype == np.float64:
            g, r = g.view(np.int64), r.view(np.int64)
        np.testing.assert_array_equal(g, r)


def test_cpu_tensors_count_no_launch():
    kernels.launches.reset()
    kernels.dq_rules(torch.ones(4, dtype=torch.float64),
                     torch.ones(4, dtype=torch.float64))
    kernels.packed_gram(torch.ones((4, 3), dtype=torch.float64))
    kernels.masked_gram(torch.ones((4, 1), dtype=torch.float64),
                        torch.ones(4, dtype=torch.float64),
                        torch.ones(4, dtype=torch.bool))
    seg = torch.tensor([0, 1, 1, 2])
    kernels.dense_segment_sum(torch.ones(4, dtype=torch.float64), seg, 3)
    kernels.sorted_segment_sum(torch.ones(4, dtype=torch.float64), seg, 3)
    assert kernels.launches.snapshot() == {
        "dq_rules": 0, "packed_gram": 0, "masked_gram": 0,
        "dense_segment_sum": 0, "sorted_segment_sum": 0}


def test_other_devices_raise_instead_of_falling_back():
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kernels.packed_gram(meta)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kernels.dq_rules(meta[:, 0], meta[:, 1])
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kernels.masked_gram(meta[:, :1], meta[:, 1], meta[:, 2])


def test_dq_rules_rejects_mixed_inputs():
    with pytest.raises(ValueError):
        kernels.dq_rules(torch.ones(3, dtype=torch.float32),
                         torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError):
        kernels.dq_rules(torch.ones(3), torch.ones(4))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Importing needs no nvcc; a build without one raises, naming it."""
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_build_key_hashes_source_and_flags(monkeypatch):
    key = kernels.build_key("packed_gram")
    assert len(key) == 16 and key == kernels.build_key("packed_gram")
    assert key != kernels.build_key("dq_rules")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    assert kernels.build_key("packed_gram") != key
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
    assert "--use_fast_math" not in kernels.NVCC_FLAGS
    # the Gramian kernels read their stage-1 threshold from the flags
    assert f"-DGRAM_SMALL_MAX_D={kernels.GRAM_SMALL_MAX_D}" in \
        kernels.NVCC_FLAGS
    # both Gramian kernels include the shared header, and an edit to it
    # changes their keys (and no other)
    header = kernels.CSRC / "gram_common.cuh"
    for name in ("packed_gram", "masked_gram"):
        assert header in kernels._local_headers(kernels.CSRC /
                                                kernels.SOURCES[name], set())
    before = {n: kernels.build_key(n) for n in kernels.SOURCES}
    real = pathlib.Path.read_bytes
    monkeypatch.setattr(pathlib.Path, "read_bytes",
                        lambda p: real(p) + (b"// edit\n" if p == header
                                             else b""))
    after = {n: kernels.build_key(n) for n in kernels.SOURCES}
    assert after["packed_gram"] != before["packed_gram"]
    assert after["masked_gram"] != before["masked_gram"]
    assert after["dq_rules"] == before["dq_rules"]


@pytest.mark.parametrize("n,D,elem", [(1, 3, 4), (40, 3, 4),
                                      (10_000_000, 3, 4), (1_000_000, 18, 4),
                                      (1_000_000, 130, 4),
                                      (1_000_000, 514, 8), (999, 514, 4)])
def test_gram_plan_covers_rows_with_bounded_partials(n, D, elem):
    chunks, rows = kernels.gram_plan(n, D, elem)
    assert 1 <= chunks <= kernels.GRAM_MAX_CHUNKS
    assert chunks * rows >= n > (chunks - 1) * rows    # no empty chunk
    assert chunks == 1 or chunks * D * D * elem <= kernels.GRAM_PARTIAL_BYTES


# The Gramians' plan (csrc/gram_common.cuh): upper-triangle tiles, row
# chunks, a fixed-order reduce over the chunks. The kernels run only on the
# card; their index map and chunk plan are Python here.

TILE_DS = sorted({*range(5, 701, 29), 63, 64, 65, 127, 128, 129, 130, 255,
                  256, 257, 513, 514, 640, 641, 700})


@pytest.mark.parametrize("D", TILE_DS)
def test_gram_tiles_cover_each_upper_tile_once(D):
    T = -(-D // kernels.GRAM_TILE)
    tiles = kernels.gram_tiles(D)
    assert len(tiles) == T * (T + 1) // 2
    assert sorted(tiles) == sorted((ti, tj) for ti in range(T)
                                   for tj in range(ti, T))
    # block b = tj (tj + 1) / 2 + ti, the kernel's order
    for b, (ti, tj) in enumerate(tiles):
        assert b == tj * (tj + 1) // 2 + ti
    # every entry i <= j of A lies in exactly one tile
    cover = np.zeros((T * kernels.GRAM_TILE,) * 2, dtype=np.int64)
    t = kernels.GRAM_TILE
    for ti, tj in tiles:
        cover[ti * t:(ti + 1) * t, tj * t:(tj + 1) * t] += 1
    upper = np.triu(np.ones((D, D), dtype=bool))
    assert (cover[:D, :D][upper] == 1).all()


def gram_plan_reference(Z: np.ndarray) -> np.ndarray:
    """``Z.T @ Z`` summed as the kernels sum it: per (upper tile, chunk)
    partials over ``gram_plan``'s chunks (the whole D x D at D <=
    GRAM_SMALL_MAX_D), entries i <= j kept; then, with several chunks, lane
    l of a warp adds chunks l, l + 32, ... and a shuffle tree adds the
    lanes; then the upper triangle is mirrored."""
    n, D = Z.shape
    chunks, rows = kernels.gram_plan(n, D, Z.itemsize)
    t = kernels.GRAM_TILE
    tiles = ([(0, 0)] if D <= kernels.GRAM_SMALL_MAX_D
             else kernels.gram_tiles(D))
    size = D if D <= kernels.GRAM_SMALL_MAX_D else t
    part = np.full((chunks, D, D), np.nan)
    for c in range(chunks):
        Zc = Z[c * rows:(c + 1) * rows]
        for ti, tj in tiles:
            I = slice(ti * size, min((ti + 1) * size, D))
            J = slice(tj * size, min((tj + 1) * size, D))
            part[c, I, J] = Zc[:, I].T @ Zc[:, J]
    lanes = np.zeros((32, D, D))
    for c in range(chunks):
        lanes[c % 32] += part[c]
    off = 16
    while off:
        lanes[:off] += lanes[off:2 * off]
        off //= 2
    A = part[0] if chunks == 1 else lanes[0]
    upper = np.triu(A)
    return upper + np.triu(upper, 1).T


@pytest.mark.parametrize("n", [1, 255, 10_007])
@pytest.mark.parametrize("D", [3, 5, 64, 130])
def test_gram_plan_reference_is_exact_on_integers(n, D):
    """On integer-valued Z every partial sum is exact in float64, so the
    plan's order of summation must give Z.T @ Z exactly, and the mirrored
    result is symmetric bit for bit; no entry is left unwritten."""
    rng = np.random.default_rng(n + D)
    Z = rng.integers(-8, 9, size=(n, D)).astype(np.float64)
    A = gram_plan_reference(Z)
    assert not np.isnan(A).any()
    np.testing.assert_array_equal(A, Z.T @ Z)
    np.testing.assert_array_equal(A, A.T)
    torch_A = kernels.packed_gram(torch.as_tensor(Z)).numpy()
    np.testing.assert_array_equal(torch_A, A)


@pytest.mark.parametrize("D", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 40, 1040, kernels.GRAM_ONE_CHUNK_ROWS])
def test_gram_plan_one_chunk_for_small_tables(n, D):
    """One block takes every row, and writes A itself: one launch."""
    for elem in (4, 8):
        chunks, rows = kernels.gram_plan(n, D, elem)
        assert chunks == 1 and rows >= n


@pytest.mark.parametrize("n,D,elem,want", [
    (kernels.GRAM_ONE_CHUNK_ROWS + 1, 3, 4, None),
    (10_000_000, 3, 4, kernels.GRAM_MAX_CHUNKS),
    (1_000_000, 514, 4, 23),       # 45 upper tiles of 64: ceil(1024 / 45)
    (1_000_000, 514, 8, 15),       # 32 MiB of float64 partials at D = 514
    (1_000_000, 130, 4, 171),      # 6 upper tiles: ceil(1024 / 6)
    (100_003, 130, 8, 171),
    (65_537, 5, 4, 257),           # one tile; 256 rows a chunk at least
    (200, 514, 4, 1),
])
def test_gram_plan_keeps_its_bounds_above_one_chunk(n, D, elem, want):
    chunks, rows = kernels.gram_plan(n, D, elem)
    assert 1 <= chunks <= kernels.GRAM_MAX_CHUNKS
    assert chunks * rows >= n > (chunks - 1) * rows    # no empty chunk
    assert chunks == 1 or chunks * D * D * elem <= kernels.GRAM_PARTIAL_BYTES
    tiles = 1 if D <= kernels.GRAM_SMALL_MAX_D else len(kernels.gram_tiles(D))
    assert chunks * tiles <= kernels.GRAM_MAX_CHUNKS + tiles
    assert chunks > 1 if want is None else chunks == want


@pytest.mark.parametrize("D", [1, 3, 4, 130, 514, 700])
def test_upper_index_maps_each_entry_once(D):
    """The chunk reduce takes one warp per entry i <= j of A through the
    same closed form as the tiles."""
    got = [kernels.upper_index(b) for b in range(D * (D + 1) // 2)]
    assert got == [(i, j) for j in range(D) for i in range(j + 1)]


def test_the_tile_width_reaches_the_kernels_through_the_flags(monkeypatch):
    """gram_tiles and the kernels' tiles must agree, so the tile width is
    passed to nvcc and is part of the build key."""
    assert f"-DGRAM_TILE={kernels.GRAM_TILE}" in kernels.NVCC_FLAGS
    key = kernels.build_key("masked_gram")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", tuple(
        f.replace(f"={kernels.GRAM_TILE}", "=128") if "GRAM_TILE" in f
        else f for f in kernels.NVCC_FLAGS))
    assert kernels.build_key("masked_gram") != key


# ---------------------------------------------------------------------------
# The segment sums (port-only kernels of csrc/segment_sum.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 65_537, 1_081_344,
                               9_611_537, 10**9])
def test_dense_segment_plan_covers_rows_in_fixed_ranges(n):
    """Contiguous row ranges, at most SEGSUM_MAX_BLOCKS, none empty, at
    least SEGSUM_MIN_ROWS_PER_BLOCK rows each but the last; the plan (and
    so the order of the adds) depends on n alone."""
    blocks, rows = kernels.dense_segment_plan(n)
    assert 1 <= blocks <= kernels.SEGSUM_MAX_BLOCKS
    assert blocks * rows >= n and (blocks - 1) * rows < max(n, 1)
    if blocks > 1:
        assert rows >= kernels.SEGSUM_MIN_ROWS_PER_BLOCK
    assert kernels.dense_segment_plan(n) == (blocks, rows)


@pytest.mark.parametrize("size,cols,elem,fits", [
    (40, 4, 4, True), (40, 8, 8, True), (352, 8, 4, True),
    (353, 8, 4, False), (131_073, 1, 4, False), (1, 1, 8, True)])
def test_dense_segment_table_must_fit_shared_memory(size, cols, elem, fits):
    assert kernels.dense_segment_fits(size, cols, elem) == fits
    need = kernels.SEGSUM_WARPS * (size + 32) * cols * elem
    assert fits == (need <= kernels.SEGSUM_SMEM_BYTES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sums_plain_versions_on_the_cpu(dtype):
    """On CPU tensors both wrappers are index_add_ into zeros, any id
    order for the dense one; (n,) and (n, C) inputs."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(1000, 3)), dtype=dtype)
    seg = torch.as_tensor(np.sort(rng.integers(0, 17, 1000)))
    want = torch.zeros((17, 3), dtype=dtype).index_add_(0, seg, x)
    for fn in (kernels.dense_segment_sum, kernels.sorted_segment_sum):
        assert torch.equal(fn(x, seg, 17), want)
        assert torch.equal(fn(x[:, 0], seg, 17), want[:, 0])
    perm = torch.as_tensor(rng.permutation(1000))
    np.testing.assert_allclose(
        kernels.dense_segment_sum(x[perm], seg[perm], 17).numpy(),
        want.numpy(), rtol=1e-12, atol=1e-5 if dtype == torch.float32
        else 1e-12)


@pytest.mark.parametrize("size", [1, 17])
@pytest.mark.parametrize("cols", [None, 3])
def test_dense_segment_sum_drops_ids_outside_the_table(size, cols):
    """The dense kernel skips a row whose id lies outside [0, size)
    (csrc/segment_sum.cu), and its plain version drops it too: the sum
    equals that of the in-range rows alone, NaN in a dropped row
    included."""
    rng = np.random.default_rng(5)
    shape = (500,) if cols is None else (500, cols)
    x = torch.as_tensor(rng.normal(size=shape))
    seg = torch.as_tensor(rng.integers(-4, size + 4, 500))
    x[seg < 0] = float("nan")
    keep = (seg >= 0) & (seg < size)
    got = kernels.dense_segment_sum(x, seg, size)
    want = kernels.dense_segment_sum(x[keep], seg[keep], size)
    assert got.shape == want.shape and not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_segment_sums_reject_bad_arguments():
    x = torch.ones(4)
    with pytest.raises(ValueError, match="int64"):
        kernels.dense_segment_sum(x, torch.zeros(4, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="int64"):
        kernels.sorted_segment_sum(x, torch.zeros(3, dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="float32 or float64"):
        kernels.sorted_segment_sum(torch.ones(4, dtype=torch.int32),
                                   torch.zeros(4, dtype=torch.int64), 1)
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kernels.dense_segment_sum(meta, torch.zeros(
            4, dtype=torch.int64, device="meta"), 1)


def test_segment_sum_plan_reaches_the_kernel_through_the_flags(monkeypatch):
    """The warp count and the tile size size the wrapper's scratch, so
    both reach nvcc and the build key; the kernel has its own library."""
    assert kernels.SOURCES["segment_sum"] == "segment_sum.cu"
    for flag in (f"-DSEGSUM_WARPS={kernels.SEGSUM_WARPS}",
                 f"-DSEGSUM_TILE={kernels.SEGSUM_TILE}"):
        assert flag in kernels.NVCC_FLAGS
    key = kernels.build_key("segment_sum")
    assert key not in {kernels.build_key(n) for n in kernels.SOURCES
                       if n != "segment_sum"}
    monkeypatch.setattr(kernels, "NVCC_FLAGS", tuple(
        f.replace(f"={kernels.SEGSUM_TILE}", "=64") if "SEGSUM_TILE" in f
        else f for f in kernels.NVCC_FLAGS))
    assert kernels.build_key("segment_sum") != key
    src = (kernels.CSRC / "segment_sum.cu").read_text()
    # no float atomic: the one atomic numbers the sorted kernel's owner list
    atomics = [line for line in src.splitlines()
               if "atomic" in line and not line.lstrip().startswith("//")]
    assert atomics and all("atomicAdd(n_owners, 1)" in a for a in atomics)
