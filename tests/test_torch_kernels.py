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
    kernels.dense_segment_sum(torch.ones(4, dtype=torch.float64), None, 1)
    kernels.sorted_segment_sum(torch.ones(4, dtype=torch.float64), seg, 3)
    kernels.dq_sketch([torch.ones(4)], torch.ones(4, dtype=torch.bool),
                      [torch.ones(4)], torch.ones(4, dtype=torch.bool))
    assert kernels.launches.snapshot() == {
        "dq_rules": 0, "packed_gram": 0, "masked_gram": 0,
        "dense_segment_sum": 0, "sorted_segment_sum": 0, "dq_sketch": 0,
        "dense_segment_sum_one_slot": 0}


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

# (size, cols, elem, ids) of each form: whole (no ids), regs, table, and
# the whole form at its most columns (SEGSUM_REG_COLS) in float64
PLAN_SHAPES = [(1, 3, 4, False), (3, 3, 8, True), (41, 3, 4, True),
               (1, 4, 8, False)]


def _plan_chunks(plan, n):
    """Each chunk's (block, thread, step) under ``plan``, as the kernel
    maps them (csrc/segment_sum.cu: block b takes chunks b * per_block ..,
    its thread t the chunks t, t + threads, .. of them, in order)."""
    threads = 32 * kernels.SEGSUM_WARPS
    chunk = np.arange(-(-n // plan.rows_per_chunk))
    block = chunk // plan.chunks_per_block
    local = chunk - block * plan.chunks_per_block
    return block, local % threads, local // threads


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["whole", "regs", "table", "whole-4-cols"])
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 65_537, 1_081_344,
                               9_611_537, 10**9])
def test_dense_segment_plan_covers_rows_in_fixed_ranges(n, shape):
    """Chunks of one 16-byte vector per column, in contiguous ranges, at
    most SEGSUM_MAX_BLOCKS (SEGSUM_TABLE_BLOCKS in the table form), none
    empty, at least SEGSUM_MIN_ROWS_PER_BLOCK rows each but the last; every
    row in exactly one chunk and every chunk in exactly one (block, thread,
    step); one level of the cross-block step for a table of at most
    SEGSUM_REG_ENTRIES entries, groups of SEGSUM_GROUP blocks past it; the
    plan (and so the order of the adds) depends on its arguments alone."""
    size, cols, elem, ids = shape
    plan = kernels.dense_segment_plan(n, size, cols, elem, ids)
    assert plan.rows_per_chunk * elem == 16
    chunks = -(-n // plan.rows_per_chunk)
    blocks, per = plan.blocks, plan.chunks_per_block
    assert blocks >= 1 and blocks * per >= chunks and (blocks - 1) * per < chunks
    most = (kernels.SEGSUM_TABLE_BLOCKS if plan.form == "table"
            else kernels.SEGSUM_MAX_BLOCKS)
    assert blocks <= most
    entries = size * cols
    if blocks > 1:
        assert per * plan.rows_per_chunk >= kernels.SEGSUM_MIN_ROWS_PER_BLOCK
        assert plan.groups == (1 if entries <= kernels.SEGSUM_REG_ENTRIES
                               else -(-blocks // kernels.SEGSUM_GROUP))
        assert plan.scratch_bytes == kernels._TICKET_BYTES + \
            (blocks + plan.groups) * entries * elem
    else:
        assert plan.groups == 0 and plan.scratch_bytes == kernels._TICKET_BYTES
    assert plan.groups + 1 <= kernels.SEGSUM_TICKETS
    if chunks <= 3_000_000:
        block, thread, step = _plan_chunks(plan, n)
        assert block.max() == blocks - 1
        assert len(set(zip(block.tolist(), thread.tolist(),
                           step.tolist()))) == chunks
        rows = np.arange(chunks)[:, None] * plan.rows_per_chunk + \
            np.arange(plan.rows_per_chunk)
        rows = rows[rows < n]
        assert np.array_equal(np.sort(rows), np.arange(n))
    assert kernels.dense_segment_plan(n, size, cols, elem, ids) == plan


@pytest.mark.parametrize("n,size,cols,elem,ids,form", [
    (10_000_000, 1, 1, 4, False, "whole"),     # global_agg's fsum
    (10_000_000, 1, 3, 4, False, "whole"),     # stat._sums (corr, cov)
    (10_000_000, 1, 1, 4, True, "regs"),       # one slot with ids
    (10_000_000, 1, 3, 4, True, "regs"),
    (9_611_537, 3, 3, 4, True, "regs"),        # KMeans' Lloyd sums
    (9_611_537, 3, 3, 8, True, "regs"),        # the silhouette, float64
    (9_611_537, 41, 3, 4, True, "table"),      # the dense GROUP BY
    (9_611_537, 128, 4, 4, True, "table"),     # GBT's histograms
    (9_611_537, 256, 4, 4, True, "table"),
    (9_611_537, 256, 2, 4, True, "table"),     # the forest's
    (9_611_537, 512, 2, 4, True, "table"),
    (31, 4, 2, 8, True, "regs"),               # edge cases
    (65_537, 300, 2, 8, True, "table"),
    (100, 1, 4, 4, False, "whole"),
    (100, 8, 5, 4, True, "table")])
def test_dense_segment_plan_form_at_held_shapes(n, size, cols, elem, ids,
                                                form):
    """Without ids the whole form; a table of at most SEGSUM_REG_ENTRIES
    entries and SEGSUM_REG_COLS columns in registers; else per-warp tables
    in shared memory."""
    assert kernels.dense_segment_plan(n, size, cols, elem, ids).form == form
    assert form in kernels.DENSE_FORMS


def test_dense_segment_plan_without_ids_has_one_slot():
    """The whole form has one slot and at most SEGSUM_REG_COLS columns."""
    with pytest.raises(ValueError, match="one slot"):
        kernels.dense_segment_plan(100, 2, 1, 4, False)
    with pytest.raises(ValueError, match="at most 4 columns"):
        kernels.dense_segment_plan(100, 1, kernels.SEGSUM_REG_COLS + 1, 4,
                                   False)


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
    """The plan's compiled constants (the warp count, the register table,
    the group of blocks the cross-block step adds, the dense and the
    sorted shared-memory ceilings, the sorted kernel's stage) reach nvcc
    and the build key; the kernel has its own library."""
    assert kernels.SOURCES["segment_sum"] == "segment_sum.cu"
    for flag in (f"-DSEGSUM_WARPS={kernels.SEGSUM_WARPS}",
                 f"-DSEGSUM_REG_ENTRIES={kernels.SEGSUM_REG_ENTRIES}",
                 f"-DSEGSUM_GROUP={kernels.SEGSUM_GROUP}",
                 f"-DSEGSUM_SMEM_BYTES={kernels.SEGSUM_SMEM_BYTES}",
                 f"-DSEGSUM_STAGE_BYTES={kernels.SEGSUM_STAGE_BYTES}",
                 "-DSEGSUM_SORTED_SMEM_BYTES="
                 f"{kernels.SEGSUM_SORTED_SMEM_BYTES}"):
        assert flag in kernels.NVCC_FLAGS
    key = kernels.build_key("segment_sum")
    assert key not in {kernels.build_key(n) for n in kernels.SOURCES
                       if n != "segment_sum"}
    for name, value in (("SEGSUM_STAGE_BYTES", 32768),
                        ("SEGSUM_REG_ENTRIES", 16), ("SEGSUM_GROUP", 8)):
        with monkeypatch.context() as m:
            m.setattr(kernels, "NVCC_FLAGS", tuple(
                f"-D{name}={value}" if f.startswith(f"-D{name}=") else f
                for f in kernels.NVCC_FLAGS))
            assert kernels.build_key("segment_sum") != key
    path = kernels.CSRC / "segment_sum.cu"
    src = "\n".join(p.read_text() for p in
                    [path] + kernels._local_headers(path, {path}))
    # no float atomic, in the source or the headers it includes: the one
    # integer atomic (tickets.cuh: arrive) hands out both kernels' tickets
    atomics = [line for line in src.splitlines()
               if "atomic" in line and not line.lstrip().startswith("//")]
    assert atomics and all("atomicAdd(counter, 1u)" in a for a in atomics)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cols", [None, 1, 3, 4])
def test_dense_segment_sum_without_ids_on_the_cpu(dtype, cols):
    """dense_segment_sum(x, None, 1) is x.sum(0, keepdim=True) bit for bit
    on a CPU tensor, and the id route with all-zero ids gives the same
    bits (NaN and -0.0 included)."""
    rng = np.random.default_rng(11)
    shape = (1000,) if cols is None else (1000, cols)
    x = torch.as_tensor(rng.normal(size=shape), dtype=dtype)
    x[7] = -0.0
    x[500] = float("nan")
    got = kernels.dense_segment_sum(x, None, 1)
    want = x.sum(0, keepdim=True)
    assert got.shape == (1,) + shape[1:]
    assert torch.equal(got.view(torch.int8), want.view(torch.int8))
    zero = kernels.dense_segment_sum(x, torch.zeros(1000, dtype=torch.int64),
                                     1)
    assert torch.equal(got.view(torch.int8), zero.view(torch.int8))
    empty = kernels.dense_segment_sum(x[:0], None, 1)
    assert empty.shape == got.shape and not empty.any()


def test_dense_segment_sum_without_ids_rejects_bad_arguments():
    x = torch.ones(4)
    with pytest.raises(ValueError, match="one slot"):
        kernels.dense_segment_sum(x, None, 2)
    with pytest.raises(ValueError, match="float32 or float64"):
        kernels.dense_segment_sum(torch.ones(4, dtype=torch.int64), None, 1)
    with pytest.raises(ValueError, match="float32 or float64"):
        kernels.dense_segment_sum(torch.ones((4, 2, 2)), None, 1)
    with pytest.raises(ValueError, match="at most 4 columns"):
        kernels.dense_segment_sum(torch.ones((4, 5)), None, 1)
    with pytest.raises(ValueError, match="int64"):
        kernels.dense_segment_sum(x, [0, 0, 0, 0], 1)
    with pytest.raises(ValueError, match="int64"):
        kernels.dense_segment_sum(x, torch.zeros(3, dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="int64"):
        kernels.dense_segment_sum(x, torch.zeros((4, 1), dtype=torch.int64),
                                  1)
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kernels.dense_segment_sum(meta, None, 1)


def test_dense_scratch_is_kept_per_stream(monkeypatch):
    """Each (device, stream) has its own scratch, whose ticket counters
    start at zero, and its own batches of one-slot outputs; a larger plan
    grows the scratch, a smaller one reuses it; each one-slot output is a
    new view, and a stream keeps one batch a shape and dtype."""
    monkeypatch.setattr(kernels, "_streams", {})
    dev = torch.device("cpu")
    a = kernels._stream_state(dev, 1, 100)
    b = kernels._stream_state(dev, 2, 100)
    assert a is not b and a.tickets != b.tickets
    assert a.tickets == a.scratch.data_ptr()
    assert a.nbytes >= kernels._TICKET_BYTES
    assert not a.scratch[:kernels._TICKET_BYTES].any()
    assert kernels._stream_state(dev, 1, 50).tickets == a.tickets
    big = kernels._stream_state(dev, 1, a.nbytes + 1)
    assert big is a and a.nbytes >= a.scratch.numel() > 0
    assert not a.scratch[:kernels._TICKET_BYTES].any()
    outs = [kernels._one_slot_output(a, (1, 3), torch.float32, dev)
            for _ in range(2 * kernels.SEGSUM_OUTPUTS + 1)]
    assert len({o.data_ptr() for o in outs}) == len(outs)
    assert all(o.shape == (1, 3) and o.is_contiguous() for o in outs)
    assert list(a.outputs) == [((1, 3), torch.float32)]
    assert not b.outputs


def test_dense_segment_plan_rejects_a_table_past_shared_memory():
    with pytest.raises(ValueError, match="does not fit"):
        kernels.dense_segment_plan(100, 5000, 4, 4)


# ---------------------------------------------------------------------------
# The sorted segment sum's plan, and a walk of it on the CPU
# ---------------------------------------------------------------------------

THREADS = 32 * kernels.SEGSUM_WARPS
# An H100 SM's shared memory and what each block reserves beside its own
# (the CUDA occupancy rules), and the sorted kernel's static shared memory
# at most (warp totals of four doubles, flags, two carried ids, a ticket
# flag), to show two blocks an SM.
SM_SHARED, BLOCK_RESERVED, SORTED_STATIC = 228 << 10, 1 << 10, 512

# (cols, elem): the held shapes (float32 C = 1 and C = 3, float64 C = 1 and
# C = 3, the Lloyd sums' d + 2 past the dense table at d = 1 and d = 3),
# the compiled column counts at their ends, counts known only at run
# time, whole rows a stage, and rows read in slabs of columns (past 24
# float32 or 12 float64 columns), up to 20,000 columns.
SORTED_SHAPES = [(1, 4), (3, 4), (1, 8), (3, 8), (2, 4), (4, 8), (5, 4),
                 (5, 8), (24, 4), (12, 8), (25, 4), (60, 8), (3000, 8),
                 (20_000, 8), (20_000, 4)]


def _sorted_blocks(plan, n):
    """Each block's (first row, end row)."""
    starts = np.arange(plan.blocks, dtype=np.int64) * plan.rows_per_block
    return starts, np.minimum(starts + plan.rows_per_block, n)


@pytest.mark.parametrize("cols,elem", SORTED_SHAPES)
@pytest.mark.parametrize("n", [1, 3, 1023, 1024, 1025, 131_584, 1_081_344,
                               9_611_537, 10**9])
def test_sorted_segment_plan_covers_rows_in_fixed_ranges(n, cols, elem):
    """Contiguous ranges of a whole number of 16-byte vectors of rows (so
    that each block's ids and values start on the grid), at least
    SEGSUM_SORTED_MIN_ROWS rows each but the last, at most
    SEGSUM_SORTED_BLOCKS of them and so at most a block's threads (the
    last block adds the partials a thread a block), none empty; stages of
    whole rows, or of slabs of whole groups of columns past a thread's
    share of a stage, an odd number of rows a thread, at most a block's
    rows, whole vectors; two stages and two carries in shared memory, two
    blocks an SM at any column count in either type; scratch for the
    tickets and two partials a block; the plan depends on its arguments
    alone."""
    plan = kernels.sorted_segment_plan(n, cols, elem, 100)
    grain = 16 // elem
    starts, ends = _sorted_blocks(plan, n)
    assert 1 <= plan.blocks <= kernels.SEGSUM_SORTED_BLOCKS <= THREADS
    assert plan.rows_per_block % grain == 0
    assert ends[-1] == n and (ends > starts).all()
    assert (starts[1:] == ends[:-1]).all() and starts[0] == 0
    if plan.blocks > 1:
        assert plan.rows_per_block >= kernels.SEGSUM_SORTED_MIN_ROWS
    K, R, W = plan.rows_per_thread, plan.stage_rows, plan.width
    assert K % 2 == 1 and R % grain == 0 and 0 < R <= plan.rows_per_block
    assert R == min(K * THREADS, plan.rows_per_block)
    row = 8 + W * elem
    # a thread's share of a stage holds a row: 24 float32 or 12 float64
    # values beside its id
    slab = (kernels.SEGSUM_STAGE_BYTES // THREADS - 8) // elem
    assert W == (cols if cols <= slab else slab)
    assert W == cols or W % kernels.SORTED_GROUP == 0
    k = kernels.SEGSUM_STAGE_BYTES // (THREADS * row)   # the kernel's
    assert k >= 1 and K == (k if k % 2 else k - 1)     # constexpr count
    group = cols if cols <= kernels.SEGSUM_REG_COLS else kernels.SORTED_GROUP
    assert plan.smem_bytes == 2 * R * row + 2 * (
        -(-W // group) * group * elem)
    assert plan.smem_bytes <= kernels.SEGSUM_SORTED_SMEM_BYTES
    assert 2 * (plan.smem_bytes + SORTED_STATIC + BLOCK_RESERVED) <= SM_SHARED
    assert plan.scratch_bytes == kernels._TICKET_BYTES + (
        2 * plan.blocks * cols * elem if plan.blocks > 1 else 0)
    assert kernels.sorted_segment_plan(n, cols, elem, 100) == plan


def test_sorted_segment_plan_at_held_shapes():
    """The held shapes: 9,611,537 rows take every block in stages of 7 / 5
    rows a thread (float32, one / three columns) and 5 / 3 (float64), the
    blocks zeroing their empty slots; PIC's 131,584 entries take 128
    blocks of 1,028 rows, one stage each, after a memset of its 64 MiB
    output; 1,000 ids onto 10^7 slots one block after a memset."""
    for cols, elem, k, size in ((1, 4, 7, 20_556), (3, 4, 5, 1024),
                                (1, 8, 5, 39), (3, 8, 3, 1024)):
        plan = kernels.sorted_segment_plan(9_611_537, cols, elem, size)
        assert plan.blocks == kernels.SEGSUM_SORTED_BLOCKS
        assert plan.rows_per_thread == k and plan.stage_rows == k * THREADS
        assert plan.width == cols and not plan.memset
    pic = kernels.sorted_segment_plan(131_584, 1, 4, 16_777_216)
    assert (pic.blocks, pic.rows_per_block, pic.stage_rows) == (128, 1028,
                                                                1028)
    assert pic.memset
    sparse = kernels.sorted_segment_plan(1000, 1, 4, 10**7)
    assert sparse.blocks == 1 and sparse.memset


@pytest.mark.parametrize("n,cols,elem,size,memset", [
    (9_611_537, 1, 4, 901_000, False), (9_611_537, 1, 4, 901_200, True),
    (100, 3, 8, 0, False), (100, 3, 8, 100, True), (1, 1, 4, 1, True)])
def test_sorted_segment_plan_memset_past_the_ratio(n, cols, elem, size,
                                                   memset):
    """A memset zeroes the output once its bytes pass the rows' (an id and
    the values) over SEGSUM_SORTED_ZERO_RATIO: the blocks' zeros below."""
    plan = kernels.sorted_segment_plan(n, cols, elem, size)
    assert plan.memset == memset
    assert (size * cols * elem * kernels.SEGSUM_SORTED_ZERO_RATIO
            > n * (8 + cols * elem)) == memset


def _slot_after(s, size):
    return 0 if s < 0 else (size if s >= size else s + 1)


def _scan(start, v, carry):
    """csrc/segment_sum.cu's segmented_scan over a block's threads, in its
    order: lanes by doubling distance, then the warps folded in order.
    Returns (v, prev)."""
    T, G = v.shape
    lanes = np.arange(32)
    starts = start.reshape(-1, 32)
    at = np.maximum.accumulate(np.where(starts, lanes, -1), axis=1)
    upto = (at >= 0).reshape(T)
    first = np.maximum(at, 0)[:, :, None]
    vv = v.reshape(-1, 32, G)
    for d in (1, 2, 4, 8, 16):                            # __shfl_up_sync
        up = np.concatenate([vv[:, :d], vv[:, :-d]], axis=1)
        vv = np.where(lanes[None, :, None] - d >= first, up + vv, vv)
    v = vv.reshape(T, G)
    totals, restart = vv[:, 31], starts.any(1)
    p = np.empty((T // 32, G))
    acc = np.zeros(G) if carry is None else np.asarray(carry, float)
    for w in range(T // 32):
        p[w] = acc
        acc = totals[w] if restart[w] else acc + totals[w]
    pw = p[np.arange(T) // 32]
    v = np.where(upto[:, None], v, pw + v)
    prev = np.where((np.arange(T) % 32 > 0)[:, None],
                    np.concatenate([v[:1], v[:-1]]), pw)
    return v, prev


def walk_sorted_plan(x, seg, size, plan):
    """The sorted kernel's work under ``plan`` on the CPU, step by step as
    csrc/segment_sum.cu does it: each block zeroes its own slots (unless a
    memset zeroed the output), reads its rows in stages, one slab of
    columns after another, adds a thread's rows in row order, writes a run
    that lies among them, scans the threads' parts by segments, carries
    the stage's last run, leaves the runs that cross its edges as head and
    tail partials; the last block scans the partials over the blocks. (The
    kernel adds a slab's columns in groups; each column's adds are the same
    in any grouping, so the walk adds the slab's columns together.) Without
    the memset the output starts as NaN, so a slot no step writes shows.
    Asserts that the blocks' zeroed slots tile [0, size) once, that each
    block writes only its own slots, and that no slot is written twice."""
    n, C = x.shape
    K, R, rpb, W = (plan.rows_per_thread, plan.stage_rows,
                    plan.rows_per_block, plan.width)
    out = np.zeros((size, C)) if plan.memset else np.full((size, C), np.nan)
    zeroed, written = np.zeros(size, int), np.zeros(size, int)
    part = np.full((plan.blocks, 2, C), np.nan)
    tid = np.arange(THREADS)
    for b in range(plan.blocks):
        r0, r1 = b * rpb, min(n, (b + 1) * rpb)
        first = seg[r0]
        open_start = r0 > 0 and seg[r0 - 1] == first
        lo = _slot_after(seg[r0 - 1], size) if r0 > 0 else 0
        hi = _slot_after(seg[r1 - 1], size) if r1 < n else size
        if not plan.memset:
            out[lo:hi] = 0.0
            zeroed[lo:hi] += 1

        def emit(s, v, c0):
            if open_start and s == first:
                part[b, 0, c0:c0 + len(v)] = v
            elif 0 <= s < size:
                assert lo <= s < hi, (b, s, lo, hi)
                out[s, c0:c0 + len(v)] = v
                written[s] += c0 == 0

        for c_lo in range(0, C, W):
            cols = slice(c_lo, min(c_lo + W, C))
            carry = carry_id = None
            for k in range(-(-(r1 - r0) // R)):
                a = r0 + k * R
                rows = min(R, r1 - a)
                ids, vals = seg[a:a + rows], x[a:a + rows, cols]
                j0 = tid * K
                j1 = np.minimum(j0 + K, rows)
                has = j0 < rows
                last = (rows - 1) // K
                fid = np.where(has, ids[np.minimum(j0, rows - 1)], 0)
                lid = np.where(has, ids[np.maximum(j1 - 1, 0)], 0)
                open_in = has & np.where(
                    tid > 0, ids[np.clip(j0 - 1, 0, rows - 1)] == fid,
                    k > 0 and carry_id == fid[0])
                open_out = has & ((tid == last)
                                  | (ids[np.minimum(j1, rows - 1)] == lid))
                if k > 0 and not open_in[0]:      # the carried run ended
                    emit(carry_id, carry, c_lo)
                m = vals.shape[1]
                head, acc = np.zeros((THREADS, m)), np.zeros((THREADS, m))
                brk = np.zeros(THREADS, bool)
                for t in range(last + 1):
                    run = fid[t]
                    for j in range(j0[t], j1[t]):
                        if ids[j] != run:
                            if brk[t]:
                                emit(run, acc[t].copy(), c_lo)
                            else:
                                head[t] = acc[t]
                            brk[t], run, acc[t] = True, ids[j], 0.0
                        acc[t] += vals[j]
                acc, prev = _scan(has & (brk | ~open_in), acc,
                                  None if k == 0 else carry)
                for t in range(last + 1):
                    if brk[t]:
                        emit(fid[t], prev[t] + head[t] if open_in[t]
                             else head[t], c_lo)
                    if not open_out[t]:
                        emit(lid[t], acc[t], c_lo)
                carry, carry_id = acc[last].copy(), lid[last]
            # the slab's last stage: the block's last run
            open_end = r1 < n and seg[r1] == carry_id
            if open_end and not (open_start and carry_id == first):
                part[b, 1, cols] = carry
            else:
                emit(carry_id, carry, c_lo)
    if plan.blocks > 1:                       # the last block's stitch
        starts, ends = _sorted_blocks(plan, n)
        pad = np.arange(THREADS) < plan.blocks
        bidx = np.minimum(np.arange(THREADS), plan.blocks - 1)
        s0, s1 = starts[bidx], ends[bidx]
        fb, lb = seg[s0], seg[s1 - 1]
        bos = pad & (s0 > 0) & (seg[np.maximum(s0 - 1, 0)] == fb)
        boe = pad & (s1 < n) & (seg[np.minimum(s1, n - 1)] == lb)
        through = bos & (fb == lb)
        done = bos & (~boe | (fb != lb)) & (fb >= 0) & (fb < size)
        v = np.where(boe[:, None], part[bidx, np.where(through, 0, 1)], 0.0)
        _, prev = _scan(~through, v, None)
        for e in np.nonzero(done)[0]:
            out[fb[e]] = prev[e] + part[e, 0]
            written[fb[e]] += 1
    assert (zeroed == (0 if plan.memset else 1)).all()
    assert (written <= 1).all()
    return out


def _sorted_case(name, rng, n, size, cols, edges=()):
    """Sorted ids and integer values of one edge case."""
    if name == "random":
        seg = np.sort(rng.integers(0, size, n))
    elif name == "edges":     # a run ends at each edge, and a row past it
        cuts = sorted({e + d for e in edges for d in (-1, 0, 1)
                       if 0 < e + d < n})
        seg = np.searchsorted(np.asarray(cuts), np.arange(n), "right")
        size = int(seg[-1]) + 1
    elif name == "one segment":
        seg = np.full(n, size - 1)
    elif name == "runs of one row":
        seg, size = np.arange(n), n
    elif name == "ids outside":
        seg = np.sort(rng.integers(-3, size + 3, n))
    elif name == "sparse":
        seg = np.sort(rng.choice(size, n, replace=False))
    x = rng.integers(-1000, 1000, (n, cols)).astype(np.float64)
    return x, seg.astype(np.int64), size


def _walk_plans(n, cols, elem, monkeypatch):
    """The plan as built, and one of small stages and blocks (SEGSUM_
    STAGE_BYTES and SEGSUM_SORTED_MIN_ROWS cut), which gives a few stages
    a block and a few blocks at a few thousand rows; each with the blocks'
    zeros and with a memset."""
    plans = [kernels.sorted_segment_plan(n, cols, elem, 1)]
    with monkeypatch.context() as m:
        m.setattr(kernels, "SEGSUM_STAGE_BYTES", THREADS * 3 * (8 + cols
                                                                 * elem))
        m.setattr(kernels, "SEGSUM_SORTED_MIN_ROWS", 1000)
        plans.append(kernels.sorted_segment_plan(n, cols, elem, 1))
    return [p._replace(memset=z) for p in plans for z in (False, True)]


@pytest.mark.parametrize("cols,elem", [(1, 4), (3, 4), (3, 8), (5, 4),
                                       (6, 8)])
@pytest.mark.parametrize("case,n,size", [
    ("random", 6000, 40), ("random", 6000, 3000), ("edges", 5000, None),
    ("one segment", 5000, 3), ("runs of one row", 2500, None),
    ("ids outside", 6000, 50), ("sparse", 700, 100_000),
    ("random", 1, 5), ("random", 33, 4), ("ids outside", 40, 3)])
def test_sorted_plan_walk_equals_reference(case, n, size, cols, elem,
                                           monkeypatch):
    """The kernel's order of adds, walked on integer-valued float64 values
    (every order exact), gives segment_sum_reference's bits at each edge:
    runs ending on a stage or block edge and a row either side of it, one
    segment over every block, runs of one row, a block's rows and fewer,
    ids below 0 and at size and past it, sparse ids with gaps of hundreds
    of slots; compiled and run-time column counts; the blocks' zeros and a
    memset."""
    rng = np.random.default_rng(n + cols)
    for plan in _walk_plans(n, cols, elem, monkeypatch):
        starts = np.arange(plan.blocks) * plan.rows_per_block
        edges = np.concatenate([starts + k * plan.stage_rows for k in range(
            -(-plan.rows_per_block // plan.stage_rows))])
        x, seg, sz = _sorted_case(case, rng, n, size or n, cols, edges)
        got = walk_sorted_plan(x, seg, sz, plan)
        want = kernels.segment_sum_reference(torch.as_tensor(x),
                                             torch.as_tensor(seg), sz)
        np.testing.assert_array_equal(got, want.numpy())
    assert plan.blocks > 1 or n < 1000


@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("case,size", [("random", 5), ("one segment", 3),
                                       ("ids outside", 4)])
def test_sorted_plan_walk_of_wide_rows_in_slabs(case, size, elem,
                                                monkeypatch):
    """20,000 columns (far past a stage's whole rows, and past any shared
    memory a block has for them): the plan reads them in slabs of 24
    float32 or 12 float64 columns, two stages and two carries of a slab in
    shared memory, and its walk over three blocks (SEGSUM_SORTED_MIN_ROWS
    cut), slab by slab, gives segment_sum_reference's bits, with the
    blocks' zeros and with a memset (the plan's own, a memset at these
    sizes, past the random case)."""
    n, cols = 48, 20_000
    with monkeypatch.context() as m:
        m.setattr(kernels, "SEGSUM_SORTED_MIN_ROWS", 16)
        plan = kernels.sorted_segment_plan(n, cols, elem, size)
    assert plan.blocks == 3 and plan.width == 96 // elem and plan.memset
    assert plan.smem_bytes <= kernels.SEGSUM_SORTED_SMEM_BYTES
    rng = np.random.default_rng(elem)
    x, seg, sz = _sorted_case(case, rng, n, size, cols)
    want = kernels.segment_sum_reference(torch.as_tensor(x),
                                         torch.as_tensor(seg), sz)
    for memset in (False, True) if case == "random" else (plan.memset,):
        got = walk_sorted_plan(x, seg, sz, plan._replace(memset=memset))
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cols", [None, 1, 3, 6])
def test_sorted_segment_sum_matches_jax_segment_sum(dtype, cols):
    """On CPU tensors sorted_segment_sum is its plain version, and matches
    jax.ops.segment_sum (what the JAX package's sorted program calls,
    sparkdq4ml_tpu/ops/segments.py) on the same seeded sorted ids, any
    column count (past SEGSUM_REG_COLS too), both types: within 1e-12
    Σ|x| a slot in float64 and 1e-5 Σ|x| in float32, the bounds the card
    holds the kernel to. Ids below 0 and at size and past it are dropped by
    both, and a NaN in a dropped row reaches no slot."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(12 + (cols or 0))
    shape = (3000,) if cols is None else (3000, cols)
    x = rng.normal(size=shape) * 100.0
    seg = np.sort(rng.integers(-3, 53, 3000))
    x[seg < 0] = np.nan
    xt = torch.as_tensor(x).to(dtype)
    got = kernels.sorted_segment_sum(xt, torch.as_tensor(seg), 50)
    assert got.dtype == dtype and got.shape == (50,) + shape[1:]
    assert torch.equal(got, kernels.segment_sum_reference(
        xt, torch.as_tensor(seg), 50))
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    want = np.asarray(jax.ops.segment_sum(
        jnp.asarray(x, jdtype), jnp.asarray(seg), num_segments=50,
        indices_are_sorted=True), np.float64)
    keep = (seg >= 0) & (seg < 50)
    bound = np.zeros((50,) + shape[1:])
    np.add.at(bound, seg[keep], np.abs(x[keep]))
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    assert not np.isnan(want).any() and not torch.isnan(got).any()
    assert (np.abs(got.double().numpy() - want) <= rel * bound).all()
