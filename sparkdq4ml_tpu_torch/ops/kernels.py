"""The hand-written Hopper kernels of the port, their plain PyTorch
versions, the build step and the launch counts.

Three kernels are the counterparts of the Pallas TPU kernels in
``sparkdq4ml_tpu/ops/pallas_kernels.py``:

* ``dq_rules`` (``csrc/dq_rules.cu``) replaces ``_dq_kernel``: the fused DQ
  chain behind ``ops/rules.py:dq_rules_fused``.
* ``packed_gram`` (``csrc/packed_gram.cu``) replaces
  ``_packed_gram_kernel``: ``A = ZᵀZ`` of the packed design, the only data
  pass of ``LinearRegression.fit``.
* ``masked_gram`` (``csrc/masked_gram.cu``) replaces ``_gram_kernel``:
  ``A = (Z·w)ᵀ(Z·w)`` with ``Z = [X, y, 1]`` read from ``X``, ``y`` and
  ``w`` directly, behind ``models/solvers.py:augmented_gram`` (the Huber
  warm start, the cross-validation fold Gramians, ``compute_gram``).

Two more are the port's own (``csrc/segment_sum.cu``), with no TPU
counterpart: ``dense_segment_sum`` and ``sorted_segment_sum`` give the
grouped engine's float sums (``ops/segments.py``) in a fixed order, where
``index_add_`` adds float atomics in no fixed order on the card.

The two Gramian kernels share their plan (``csrc/gram_common.cuh``):
upper-triangle tiles over row chunks, then, when there is more than one
chunk, a fixed-order reduce over the chunks; one launch in all when there
is one.

Dispatch has one rule. A CUDA tensor goes to the kernel and a CPU tensor
to the plain version; any other device raises. A build or launch failure
raises too: nothing falls back from a kernel to its plain version.

The CUDA sources are compiled with ``nvcc`` into one shared library each
(plain ``extern "C"`` launchers, called through ``ctypes``) at first use,
into ``.kernels_build/<hash>/`` at the root of the checkout, keyed by a
hash of the sources, the headers they include and the flags. Importing
this module needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from .rules import (BAD_ROW_SENTINEL, CORRELATION_MAX_GUESTS,
                    CORRELATION_MAX_PRICE, MIN_PRICE)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / ".kernels_build"
SOURCES = {"dq_rules": "dq_rules.cu", "packed_gram": "packed_gram.cu",
           "masked_gram": "masked_gram.cu", "segment_sum": "segment_sum.cu"}
# The wrappers that launch a kernel, each with its launch count.
KERNELS = ("dq_rules", "packed_gram", "masked_gram", "dense_segment_sum",
           "sorted_segment_sum")
# Launches counted again by what they were given: dense_segment_sum onto a
# table of one slot (the global sums), with slot ids or without.
SUBCOUNTS = ("dense_segment_sum_one_slot",)

# Stage-1 form of both Gramian kernels (csrc/gram_common.cuh): D <=
# GRAM_SMALL_MAX_D keeps the D x D sum in registers, one block per chunk;
# larger D uses GRAM_TILE x GRAM_TILE output tiles of the upper triangle.
# The kernels read both from the nvcc flags below, the chunk plan from here.
GRAM_SMALL_MAX_D = 4
GRAM_TILE = 64
# Up to this many rows at D <= GRAM_SMALL_MAX_D, one block takes all the
# rows and writes A itself: one launch, no partials. On the card one block
# was as fast as the chunked plan or faster up to about this size.
GRAM_ONE_CHUNK_ROWS = 16384
# The dense segment sum's plan (csrc/segment_sum.cu, dense_segment_plan):
# rows in chunks of one 16-byte vector per column (4 float rows, 2 double
# rows); contiguous chunk ranges of at least SEGSUM_MIN_ROWS_PER_BLOCK rows,
# at most SEGSUM_MAX_BLOCKS of them for a table in registers (two a Hopper
# SM) and SEGSUM_TABLE_BLOCKS for a table in shared memory (three an SM,
# whose rows take longer each); one launch a call. A table of at most
# SEGSUM_REG_ENTRIES entries (slots x columns, at most SEGSUM_REG_COLS
# columns) lives in each thread's registers; a larger one in a table per
# warp (SEGSUM_WARPS) in shared memory, up to SEGSUM_SMEM_BYTES a block
# with room for 32 rows more (dense_segment_fits: the rule that sends a
# table to this kernel); past that a table takes the sorted kernel after a
# stable sort of the slot ids (ops/segments.py). The blocks' partial tables
# are added by the last block to finish (a table in registers), or by the
# last block of each group of SEGSUM_GROUP and then the last group. The
# block counts were chosen on an H100 (PERF.md section 6); they are fixed
# numbers, so the order of the adds does not depend on the card.
SEGSUM_MIN_ROWS_PER_BLOCK = 4096
SEGSUM_MAX_BLOCKS = 264
SEGSUM_TABLE_BLOCKS = 396
SEGSUM_WARPS = 8
SEGSUM_SMEM_BYTES = 96 << 10
SEGSUM_REG_ENTRIES = 32
SEGSUM_REG_COLS = 4         # the column counts segment_sum.cu compiles for
SEGSUM_GROUP = 16
# The sorted segment sum's plan (csrc/segment_sum.cu, sorted_segment_plan):
# blocks of SEGSUM_WARPS warps, each a contiguous range of rows (a
# multiple of 16 bytes' worth, so that every range starts on the 16-byte
# grid), at least SEGSUM_SORTED_MIN_ROWS rows each and at most
# SEGSUM_SORTED_BLOCKS of them (about two an H100 SM; the last block adds
# the cross-block partials a thread a block, so at most a block's
# threads). A block reads its range in stages of at most
# SEGSUM_STAGE_BYTES of ids and values, two stage buffers in its shared
# memory: one stage in flight while the one before is added. A stage holds
# whole rows up to the columns that leave a thread one row of it (24
# float32, 12 float64), else slabs of that many columns, so that shared
# memory stays under SEGSUM_SORTED_SMEM_BYTES (the ceiling raised once a
# device) at any column count. On an H100 (PERF.md section 6) stages of
# 26 KB ran faster than 13 and 52 KB, two buffers no slower than three or
# four, and 256 blocks faster than 128-224. An output of more than
# 1 / SEGSUM_SORTED_ZERO_RATIO of the rows' bytes is zeroed by a memset
# before the launch; a smaller one by the blocks, each over its own empty
# slots, where one block may have to zero them all. The numbers are fixed,
# so the order of the adds does not depend on the card.
# The kernels read SEGSUM_WARPS, SEGSUM_REG_ENTRIES, SEGSUM_GROUP,
# SEGSUM_SMEM_BYTES, SEGSUM_STAGE_BYTES and SEGSUM_SORTED_SMEM_BYTES from
# the nvcc flags below; the block counts are launch arguments.
SEGSUM_SORTED_BLOCKS = 256
SEGSUM_SORTED_MIN_ROWS = 1024
SEGSUM_STAGE_BYTES = 26 << 10
SEGSUM_SORTED_SMEM_BYTES = 56 << 10
SEGSUM_SORTED_ZERO_RATIO = 32
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC",
              f"-DGRAM_SMALL_MAX_D={GRAM_SMALL_MAX_D}",
              f"-DGRAM_TILE={GRAM_TILE}", f"-DSEGSUM_WARPS={SEGSUM_WARPS}",
              f"-DSEGSUM_REG_ENTRIES={SEGSUM_REG_ENTRIES}",
              f"-DSEGSUM_GROUP={SEGSUM_GROUP}",
              f"-DSEGSUM_SMEM_BYTES={SEGSUM_SMEM_BYTES}",
              f"-DSEGSUM_STAGE_BYTES={SEGSUM_STAGE_BYTES}",
              f"-DSEGSUM_SORTED_SMEM_BYTES={SEGSUM_SORTED_SMEM_BYTES}")
# Partial Gramians of stage 1 stay under this many bytes (about 2 MB a
# chunk at D = 514 in float64, so at most 15 chunks there).
GRAM_PARTIAL_BYTES = 32 << 20
GRAM_MAX_CHUNKS = 1024
GRAM_MIN_ROWS_PER_CHUNK = 256


class LaunchCounts:
    """How many times each wrapper launched its kernel, and the launches
    of ``SUBCOUNTS``. A call that runs the plain version, or launches
    nothing (n = 0), does not count."""

    def __init__(self):
        self._counts = dict.fromkeys(KERNELS + SUBCOUNTS, 0)
        self._lock = threading.Lock()

    def add(self, *names: str) -> None:
        with self._lock:
            for name in names:
                self._counts[name] += 1

    def reset(self) -> None:
        with self._lock:
            self._counts = dict.fromkeys(KERNELS + SUBCOUNTS, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)


launches = LaunchCounts()


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "sparkdq4ml_tpu_torch cannot be built")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _local_headers(path: Path, seen: set) -> list:
    """The files of ``csrc/`` that ``path`` includes with quotes, directly
    or through another of them, in include order."""
    out = []
    for m in _INCLUDE.finditer(path.read_bytes()):
        header = path.parent / m.group(1).decode()
        if header not in seen and header.exists():
            seen.add(header)
            out += [header] + _local_headers(header, seen)
    return out


def build_key(name: str) -> str:
    """Hash of one kernel's source, the headers it includes and the nvcc
    flags."""
    src = CSRC / SOURCES[name]
    h = hashlib.sha256()
    for path in [src] + _local_headers(src, {src}):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_ROOT / build_key(name) / f"lib{name}.so"


_libs: dict = {}
_build_lock = threading.Lock()


def build(names=tuple(SOURCES)) -> dict:
    """Compile every kernel in ``names`` whose library is not built yet,
    one ``nvcc`` each, all started together; load each library once.
    Raises with the compiler's output if a build fails."""
    with _build_lock:
        todo = [n for n in names if n not in _libs]
        missing = [n for n in todo if not library_path(n).exists()]
        nvcc = _nvcc() if missing else None
        procs = {}
        for name in missing:
            out = library_path(name)
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / SOURCES[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in todo:
            _libs[name] = _bind(name, ctypes.CDLL(str(library_path(name))))
        return {n: _libs[n] for n in names}


def _bind(name: str, lib) -> dict:
    """The library's launchers, keyed by input dtype (for ``masked_gram``
    by ``(dtype, weight dtype)``, for ``segment_sum`` by ``(kernel,
    dtype)``)."""
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    f32, f64, b8 = torch.float32, torch.float64, torch.bool
    if name == "dq_rules":
        groups = [({f32: lib.dq_rules_f32, f64: lib.dq_rules_f64},
                   [P, P, P, P, P, LL, P])]
    elif name == "packed_gram":
        groups = [({f32: lib.packed_gram_f32, f64: lib.packed_gram_f64},
                   [P, P, P, LL, I, I, LL, P])]
    elif name == "masked_gram":
        groups = [({(f32, b8): lib.masked_gram_f32_b8,
                    (f32, f32): lib.masked_gram_f32_f32,
                    (f64, b8): lib.masked_gram_f64_b8,
                    (f64, f64): lib.masked_gram_f64_f64},
                   [P, P, P, P, P, LL, I, I, LL, P])]
    else:
        groups = [({("dense", f32): lib.dense_segment_sum_f32,
                    ("dense", f64): lib.dense_segment_sum_f64},
                   [P, P, P, P, ctypes.POINTER(_DenseArgs), I, P]),
                  ({("sorted", f32): lib.sorted_segment_sum_f32,
                    ("sorted", f64): lib.sorted_segment_sum_f64},
                   [P, P, P, P, ctypes.POINTER(_SortedArgs), LL, I, P])]
    fns = {}
    for group, argtypes in groups:
        for key, fn in group.items():
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[key] = fn
    return fns


def _launcher(name: str, key):
    lib = _libs.get(name) or build((name,))[name]
    if key not in lib:
        raise TypeError(f"{name}: no kernel for dtype {key}")
    return lib[key]


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _route(name: str, *tensors: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version (CPU
    tensors); raises for anything else."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on several devices "
                             f"{[u.device for u in tensors]}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for {dev}")


# ---------------------------------------------------------------------------
# dq_rules
# ---------------------------------------------------------------------------

def dq_rules_reference(price: torch.Tensor, guest: torch.Tensor):
    """Plain version: the ``torch.where`` chain of ``ops/rules.py``."""
    sentinel = price.new_full((), BAD_ROW_SENTINEL)
    pnm = torch.where(price < MIN_PRICE, sentinel, price)
    bad = (guest < CORRELATION_MAX_GUESTS) & (price > CORRELATION_MAX_PRICE)
    null = torch.isnan(price) | torch.isnan(guest)
    pcc = torch.where(bad | null, sentinel, price)
    return pnm, pcc, (pnm > 0) & (pcc > 0)


def dq_rules(price: torch.Tensor, guest: torch.Tensor):
    """``(price_no_min, price_correct_correl, keep)`` of two float columns
    of one dtype (float32 or float64)."""
    if price.dtype != guest.dtype or price.shape != guest.shape \
            or price.ndim != 1:
        raise ValueError("dq_rules: price and guest must be 1-D columns of "
                         "one shape and dtype")
    if not _route("dq_rules", price, guest):
        return dq_rules_reference(price, guest)
    fn = _launcher("dq_rules", price.dtype)
    price, guest = price.contiguous(), guest.contiguous()
    n = price.shape[0]
    pnm, pcc = torch.empty_like(price), torch.empty_like(price)
    keep = torch.empty(n, dtype=torch.bool, device=price.device)
    if n == 0:
        return pnm, pcc, keep
    stream = torch.cuda.current_stream(price.device).cuda_stream
    _check("dq_rules", fn(price.data_ptr(), guest.data_ptr(), pnm.data_ptr(),
                          pcc.data_ptr(), keep.data_ptr(), n, stream))
    launches.add("dq_rules")
    return pnm, pcc, keep


# ---------------------------------------------------------------------------
# packed_gram
# ---------------------------------------------------------------------------

def packed_gram_reference(Z: torch.Tensor) -> torch.Tensor:
    """Plain version: ``Z.T @ Z``."""
    return Z.T @ Z


def upper_index(b: int) -> tuple[int, int]:
    """``(i, j)``, ``i <= j``, of the linear index ``b = j (j + 1) / 2 + i``
    of an upper triangle: the closed form of ``upper_index`` in
    ``csrc/gram_common.cuh``."""
    c = int((math.sqrt(8.0 * b + 1.0) - 1.0) * 0.5)
    while (c + 1) * (c + 2) // 2 <= b:
        c += 1
    while c * (c + 1) // 2 > b:
        c -= 1
    return b - c * (c + 1) // 2, c


def gram_tiles(D: int) -> list[tuple[int, int]]:
    """The output tiles ``(ti, tj)``, ``ti <= tj``, of the tiled stage 1,
    indexed by block as the kernel maps them."""
    T = -(-D // GRAM_TILE)
    return [upper_index(b) for b in range(T * (T + 1) // 2)]


def gram_plan(n: int, D: int, elem_bytes: int) -> tuple[int, int]:
    """``(chunks, rows_per_chunk)`` of the stage-1 grid: one chunk up to
    ``GRAM_ONE_CHUNK_ROWS`` rows at D <= ``GRAM_SMALL_MAX_D``; otherwise
    about a thousand blocks in all, partials under ``GRAM_PARTIAL_BYTES``,
    no empty chunk."""
    if D <= GRAM_SMALL_MAX_D and n <= GRAM_ONE_CHUNK_ROWS:
        return 1, n
    tiles = 1 if D <= GRAM_SMALL_MAX_D else len(gram_tiles(D))
    cap = max(1, min(GRAM_MAX_CHUNKS,
                     GRAM_PARTIAL_BYTES // (D * D * elem_bytes)))
    want = max(1, -(-GRAM_MAX_CHUNKS // tiles))
    chunks = max(1, min(cap, want, -(-n // GRAM_MIN_ROWS_PER_CHUNK)))
    rows = -(-n // chunks)
    return -(-n // rows), rows


def _partials(chunks: int, D: int, like: torch.Tensor):
    """Stage 1's partial Gramians, or None (a null pointer) for one chunk,
    where stage 1 writes A itself."""
    if chunks == 1:
        return None
    return torch.empty((chunks, D, D), dtype=like.dtype, device=like.device)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def packed_gram(Z: torch.Tensor) -> torch.Tensor:
    """``A = ZᵀZ`` of a pre-masked packed design ``Z`` (n, D); zeros when
    n = 0. Bit-identical from run to run on the card."""
    if Z.ndim != 2:
        raise ValueError("packed_gram: Z must be 2-D")
    if not _route("packed_gram", Z):
        return packed_gram_reference(Z)
    fn = _launcher("packed_gram", Z.dtype)
    n, D = Z.shape
    if n == 0 or D == 0:
        return torch.zeros((D, D), dtype=Z.dtype, device=Z.device)
    Z = Z.contiguous()
    out = torch.empty((D, D), dtype=Z.dtype, device=Z.device)
    chunks, rows = gram_plan(n, D, Z.element_size())
    part = _partials(chunks, D, Z)
    stream = torch.cuda.current_stream(Z.device).cuda_stream
    _check("packed_gram", fn(Z.data_ptr(), _ptr(part), out.data_ptr(),
                             n, D, chunks, rows, stream))
    launches.add("packed_gram")
    return out


# ---------------------------------------------------------------------------
# masked_gram
# ---------------------------------------------------------------------------

def masked_gram_reference(X: torch.Tensor, y: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Plain version, the XLA expression of ``augmented_gram``:
    ``Zw = [X, y, 1]·w``, ``Zw.T @ Zw``."""
    Z = torch.cat([X, y[:, None], torch.ones_like(y)[:, None]], dim=1)
    Zw = Z * w.to(X.dtype)[:, None]
    return Zw.T @ Zw


def masked_gram(X: torch.Tensor, y: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """``A = Σᵢ wᵢ² zᵢzᵢᵀ`` with ``zᵢ = [xᵢ, yᵢ, 1]``, shape (d+2, d+2), of
    ``X`` (n, d), ``y`` (n) and a weight ``w`` (n) that is boolean or of
    ``X``'s float type (float32 or float64); zeros when n = 0.
    Bit-identical from run to run on the card."""
    if X.ndim != 2 or y.shape != (X.shape[0],) or w.shape != y.shape:
        raise ValueError("masked_gram: X must be (n, d), y and w (n,)")
    if y.dtype != X.dtype or (w.dtype != torch.bool and w.dtype != X.dtype):
        raise ValueError("masked_gram: y must have X's dtype, w X's dtype "
                         "or bool")
    if not _route("masked_gram", X, y, w):
        return masked_gram_reference(X, y, w)
    fn = _launcher("masked_gram", (X.dtype, w.dtype))
    n, d = X.shape
    D = d + 2
    if n == 0:
        return torch.zeros((D, D), dtype=X.dtype, device=X.device)
    X, y, w = X.contiguous(), y.contiguous(), w.contiguous()
    out = torch.empty((D, D), dtype=X.dtype, device=X.device)
    chunks, rows = gram_plan(n, D, X.element_size())
    part = _partials(chunks, D, X)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    _check("masked_gram", fn(X.data_ptr(), y.data_ptr(), w.data_ptr(),
                             _ptr(part), out.data_ptr(), n, d, chunks,
                             rows, stream))
    launches.add("masked_gram")
    return out


# ---------------------------------------------------------------------------
# dense_segment_sum and sorted_segment_sum (port-only: no TPU kernel)
# ---------------------------------------------------------------------------

def segment_sum_reference(x: torch.Tensor, seg: torch.Tensor,
                          size: int) -> torch.Tensor:
    """Plain version of both segment sums: ``index_add_`` into zeros (the
    order of XLA's scatter-add on the CPU); one segment is a plain
    ``sum`` (pairwise, as XLA's reduce, where a row-order float32 sum of
    millions of rows would drift by 1e-4 and more). A row whose id lies
    outside ``[0, size)`` is dropped, as the dense kernel drops it: it
    adds a zero to slot 0 (no host read decides it)."""
    keep = (seg >= 0) & (seg < size)
    x = torch.where(keep.view((-1,) + (1,) * (x.ndim - 1)), x,
                    torch.zeros((), dtype=x.dtype, device=x.device))
    if size == 1:
        return x.sum(0, keepdim=True)
    seg = torch.where(keep, seg, 0)
    cols = math.prod(x.shape[1:])
    flat = x.reshape(x.shape[0], cols)
    # one column at a time: each slot takes its rows' adds in row order
    out = torch.zeros((cols, size), dtype=x.dtype, device=x.device)
    for c in range(cols):
        out[c].index_add_(0, seg, flat[:, c])
    return out.T.reshape((size,) + tuple(x.shape[1:]))


def dense_segment_fits(size: int, columns: int, elem_bytes: int) -> bool:
    """True when the dense kernel's per-warp tables of ``size`` slots and
    ``columns`` columns, with their staging rows, fit its shared memory."""
    return (SEGSUM_WARPS * (size + 32) * columns * elem_bytes
            <= SEGSUM_SMEM_BYTES)


# The dense kernel's forms, numbered as csrc/segment_sum.cu numbers them.
DENSE_FORMS = ("whole", "regs", "table")
# Counters a stream's scratch keeps for the segment sums' tickets: the
# dense kernel's one a group of blocks and one more (the plan asserts it is
# enough), the sorted kernel's the first.
SEGSUM_TICKETS = 1024


class DensePlan(NamedTuple):
    """One launch of the dense kernel: its form (and the form's number in
    ``DENSE_FORMS``, as the kernel takes it), ``blocks`` blocks that each
    take ``chunks_per_block`` consecutive chunks of ``rows_per_chunk`` rows
    (the last block fewer), and the cross-block step: none with one block,
    one level (``groups`` 1) for a table of at most ``SEGSUM_REG_ENTRIES``
    entries, else ``groups`` groups of ``SEGSUM_GROUP`` blocks; the bytes
    of a stream's scratch it needs (ticket counters, then the partial
    tables)."""
    form: str
    form_index: int
    blocks: int
    chunks_per_block: int
    rows_per_chunk: int
    groups: int
    scratch_bytes: int


def dense_segment_plan(n: int, size: int, cols: int, elem_bytes: int,
                       ids: bool = True) -> DensePlan:
    """The dense kernel's plan for n >= 1 rows (n = 0 launches nothing) of
    ``cols`` columns of ``elem_bytes`` bytes onto ``size`` slots, with slot
    ids or (``ids=False``, ``size`` 1, at most ``SEGSUM_REG_COLS``
    columns) without. The form: ``whole`` without ids, ``regs`` for a table
    of at most ``SEGSUM_REG_ENTRIES`` entries, ``table`` otherwise. Rows go
    in chunks of one 16-byte vector per column, chunks in
    contiguous ranges of at least ``SEGSUM_MIN_ROWS_PER_BLOCK`` rows, at
    most ``SEGSUM_MAX_BLOCKS`` of them (``SEGSUM_TABLE_BLOCKS`` in the
    table form), none empty. The order of every add follows from the plan
    and the ids, so the plan depends on its arguments alone. Raises for a
    table that does not fit (``dense_segment_fits``)."""
    if not ids and (size != 1 or cols > SEGSUM_REG_COLS):
        raise ValueError(f"dense_segment_plan: without ids the table has "
                         f"one slot and at most {SEGSUM_REG_COLS} columns")
    if not dense_segment_fits(size, cols, elem_bytes):
        raise ValueError(f"dense_segment_sum: a table of {size} slots and "
                         f"{cols} columns does not fit shared memory")
    if not ids:
        form = "whole"
    elif cols <= SEGSUM_REG_COLS and size * cols <= SEGSUM_REG_ENTRIES:
        form = "regs"
    else:
        form = "table"
    rows_per_chunk = 16 // elem_bytes
    chunks = -(-n // rows_per_chunk)
    most = SEGSUM_TABLE_BLOCKS if form == "table" else SEGSUM_MAX_BLOCKS
    blocks = max(1, min(most, n // SEGSUM_MIN_ROWS_PER_BLOCK, chunks))
    per_block = -(-chunks // blocks)
    blocks = -(-chunks // per_block)
    entries = size * cols
    if blocks == 1:
        groups = 0
    elif entries <= SEGSUM_REG_ENTRIES:
        groups = 1
    else:
        groups = -(-blocks // SEGSUM_GROUP)
    if groups + 1 > SEGSUM_TICKETS:
        raise ValueError(f"dense_segment_plan: {groups} groups of blocks "
                         f"need more than {SEGSUM_TICKETS} tickets")
    scratch = _TICKET_BYTES + (
        (blocks + groups) * entries * elem_bytes if blocks > 1 else 0)
    return DensePlan(form, DENSE_FORMS.index(form), blocks, per_block,
                     rows_per_chunk, groups, scratch)


class _DenseArgs(ctypes.Structure):
    """A launch's arguments that follow from its plan alone, as
    csrc/segment_sum.cu's DenseArgs lays them out: passed as one pointer,
    they save the launch about a microsecond of argument conversion."""
    _fields_ = [("n", ctypes.c_longlong),
                ("chunks_per_block", ctypes.c_longlong),
                ("C", ctypes.c_int), ("slots", ctypes.c_int),
                ("form", ctypes.c_int), ("blocks", ctypes.c_int),
                ("ticket_bytes", ctypes.c_longlong)]


@functools.lru_cache(maxsize=4096)
def _dense_call(n: int, size: int, cols: int, elem_bytes: int,
                ids: bool) -> tuple:
    """The plan of one launch and its arguments as the launcher takes
    them."""
    plan = dense_segment_plan(n, size, cols, elem_bytes, ids)
    return plan, _DenseArgs(n, plan.chunks_per_block, cols, size,
                            plan.form_index, plan.blocks, _TICKET_BYTES)


class SortedPlan(NamedTuple):
    """One launch of the sorted kernel: ``blocks`` blocks of
    ``rows_per_block`` consecutive rows each (the last fewer), read in
    stages of ``stage_rows`` rows of ``width`` columns (all of them, or a
    slab), ``rows_per_thread`` consecutive rows a thread in a stage; the
    dynamic shared memory a block (two stages and two carries of the
    stage's columns, rounded up to whole groups of ``SORTED_GROUP``), the
    bytes of a stream's scratch (the ticket counters, then two partials of
    the columns a block), and whether a memset zeroes the output before
    the launch (else the blocks zero their empty slots)."""
    blocks: int
    rows_per_block: int
    stage_rows: int
    rows_per_thread: int
    width: int
    smem_bytes: int
    scratch_bytes: int
    memset: bool


# Columns the sorted kernel adds together when their count is known only
# when it runs (more than SEGSUM_REG_COLS): csrc/segment_sum.cu,
# kSortedGroup.
SORTED_GROUP = 4


def sorted_segment_plan(n: int, cols: int, elem_bytes: int,
                        size: int) -> SortedPlan:
    """The sorted kernel's plan for n >= 1 rows (n = 0 launches nothing) of
    ``cols`` columns of ``elem_bytes`` bytes with nondecreasing int64 ids
    onto ``size`` slots. A stage's columns: all, up to as many whole groups
    as leave a thread one row of a stage of ``SEGSUM_STAGE_BYTES`` (id and
    values), else slabs of that many. Rows a thread: as many as fill a
    stage, made odd so that the lanes' rows in shared memory fall on
    different banks (the kernel computes the same number for one to
    ``SEGSUM_REG_COLS`` columns and refuses a plan that differs). Blocks:
    contiguous ranges of a multiple of 16 bytes' worth of rows, at least
    ``SEGSUM_SORTED_MIN_ROWS`` rows, at most ``SEGSUM_SORTED_BLOCKS`` of
    them, none empty. A memset where the output's bytes pass the rows'
    over ``SEGSUM_SORTED_ZERO_RATIO``. The order of every add follows from
    the plan and the ids, so the plan depends on its arguments alone."""
    threads = 32 * SEGSUM_WARPS
    grain = 16 // elem_bytes          # rows of a 16-byte vector
    slab = max(SORTED_GROUP, (SEGSUM_STAGE_BYTES // threads - 8)
               // elem_bytes // SORTED_GROUP * SORTED_GROUP)
    width = cols if cols <= slab else slab
    row = 8 + width * elem_bytes
    per_thread = max(1, SEGSUM_STAGE_BYTES // (threads * row))
    per_thread -= 1 - per_thread % 2
    blocks = max(1, min(SEGSUM_SORTED_BLOCKS, n // SEGSUM_SORTED_MIN_ROWS))
    per_block = -(-(-(-n // blocks)) // grain) * grain
    blocks = -(-n // per_block)
    stage = min(per_thread * threads, per_block)
    group = cols if cols <= SEGSUM_REG_COLS else SORTED_GROUP
    smem = 2 * stage * row + 2 * -(-width // group) * group * elem_bytes
    scratch = _TICKET_BYTES + (2 * blocks * cols * elem_bytes
                               if blocks > 1 else 0)
    memset = (size * cols * elem_bytes * SEGSUM_SORTED_ZERO_RATIO
              > n * (8 + cols * elem_bytes))
    return SortedPlan(blocks, per_block, stage, per_thread, width, smem,
                      scratch, memset)


class _SortedArgs(ctypes.Structure):
    """The sorted kernel's launch arguments that follow from its plan
    alone, as csrc/segment_sum.cu's SortedArgs lays them out."""
    _fields_ = [("n", ctypes.c_longlong),
                ("rows_per_block", ctypes.c_longlong),
                ("ticket_bytes", ctypes.c_longlong),
                ("C", ctypes.c_int), ("width", ctypes.c_int),
                ("blocks", ctypes.c_int), ("stage_rows", ctypes.c_int),
                ("per_thread", ctypes.c_int), ("smem", ctypes.c_int),
                ("memset", ctypes.c_int)]


@functools.lru_cache(maxsize=4096)
def _sorted_call(n: int, cols: int, elem_bytes: int, size: int) -> tuple:
    """The plan of one launch of the sorted kernel and its arguments as
    the launcher takes them."""
    plan = sorted_segment_plan(n, cols, elem_bytes, size)
    return plan, _SortedArgs(n, plan.rows_per_block, _TICKET_BYTES, cols,
                             plan.width, plan.blocks, plan.stage_rows,
                             plan.rows_per_thread, plan.smem_bytes,
                             plan.memset)


# Each (device, stream) keeps its own scratch for both segment-sum kernels:
# SEGSUM_TICKETS zeroed ticket counters, which every call leaves at zero,
# then the partial tables. A call runs on its stream's scratch, after every
# earlier call there, so two calls never share a counter or a table.
_TICKET_BYTES = 4 * SEGSUM_TICKETS
# Outputs of one slot and at most SEGSUM_REG_COLS columns (the global
# sums) are views of a batch of SEGSUM_OUTPUTS made at once, a new view a
# call: there the kernel takes about as long as the host path, and an
# allocation a call (5-10 us on the card's host; PERF.md section 6) lost
# the race with `sum`. A stream keeps at most one batch for each of these
# (2 x (SEGSUM_REG_COLS + 1)) shapes and dtypes, each of at most 1 KiB;
# every other output is allocated by its call.
SEGSUM_OUTPUTS = 32


class _StreamState:
    __slots__ = ("scratch", "tickets", "nbytes", "outputs")

    def __init__(self):
        self.scratch, self.tickets, self.nbytes = None, 0, 0
        self.outputs: dict = {}


_streams: dict = {}


def _stream_state(device: torch.device, stream: int,
                  nbytes: int) -> _StreamState:
    """The state of (``device``, ``stream``), its scratch at least
    ``nbytes`` long (made anew, zeroed on this stream before the launch
    that needs it, when it is shorter)."""
    state = _streams.get((device.index, stream))
    if state is None:
        state = _streams[(device.index, stream)] = _StreamState()
    if state.nbytes < nbytes:
        state.scratch = torch.zeros(max(nbytes, _TICKET_BYTES + (1 << 16)),
                                    dtype=torch.uint8, device=device)
        state.tickets = state.scratch.data_ptr()
        state.nbytes = state.scratch.numel()
    return state


def _one_slot_output(state: _StreamState, shape: tuple, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """A new output of one slot: a view of the stream's batch for this
    shape and dtype, made anew when it is used up."""
    pool = state.outputs.get((shape, dtype))
    if not pool:
        pool = state.outputs[(shape, dtype)] = list(torch.empty(
            (SEGSUM_OUTPUTS,) + shape, dtype=dtype, device=device).unbind(0))
    return pool.pop()


def _raw_stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle (torch's
    raw getter: ``torch.cuda.current_stream`` builds a Stream object, a few
    microseconds that the one-slot sums would show)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _segment_args(name: str, x: torch.Tensor, seg: torch.Tensor):
    if x.ndim not in (1, 2) or not isinstance(seg, torch.Tensor) \
            or seg.shape != x.shape[:1] or seg.dtype != torch.int64:
        raise ValueError(f"{name}: x must be (n,) or (n, C) and seg an "
                         "int64 (n,) tensor")
    if x.dtype not in _FLOATS:
        raise ValueError(f"{name}: x must be float32 or float64")


_FLOATS = (torch.float32, torch.float64)


def dense_segment_sum(x: torch.Tensor, seg: torch.Tensor | None,
                      size: int) -> torch.Tensor:
    """``out[s] = Σ x[i] over seg[i] == s`` for slot ids ``seg`` in any
    order: shape ``(size,) + x.shape[1:]``. A row whose id lies outside
    ``[0, size)`` is dropped, by the kernel and by the plain version
    alike. ``seg=None`` (with ``size`` 1 and at most ``SEGSUM_REG_COLS``
    columns) sums every row into one slot and reads no ids: the plain
    version is then ``x.sum(0, keepdim=True)``.
    On the card the order of the adds is fixed by ``dense_segment_plan``
    and the ids, so the result is bit-identical from run to run; the table
    must pass ``dense_segment_fits``. One launch a call."""
    if seg is None:
        if size != 1:
            raise ValueError("dense_segment_sum: without slot ids the "
                             "table has one slot (size 1)")
        if x.ndim not in (1, 2) or x.dtype not in _FLOATS:
            raise ValueError("dense_segment_sum: x must be a float32 or "
                             "float64 (n,) or (n, C) tensor")
        if x.ndim == 2 and x.shape[1] > SEGSUM_REG_COLS:
            raise ValueError(f"dense_segment_sum: without slot ids at most "
                             f"{SEGSUM_REG_COLS} columns")
        if x.device.type != "cuda" and not _route("dense_segment_sum", x):
            return x.sum(0, keepdim=True)
    else:
        _segment_args("dense_segment_sum", x, seg)
        if not _route("dense_segment_sum", x, seg):
            return segment_sum_reference(x, seg, size)
    shape = x.shape
    n, C = shape[0], (shape[1] if len(shape) == 2 else 1)
    dtype, dev = x.dtype, x.device
    elem = x.element_size()
    if n == 0 or C == 0:
        if not dense_segment_fits(size, C, elem):
            raise ValueError(f"dense_segment_sum: a table of {size} slots "
                             f"and {C} columns does not fit shared memory")
        return torch.zeros((size,) + shape[1:], dtype=dtype, device=dev)
    plan, args = _dense_call(n, size, C, elem, seg is not None)
    fn = _launcher("segment_sum", ("dense", dtype))
    if not x.is_contiguous():
        x = x.contiguous()
    sp = 0
    if seg is not None:
        if not seg.is_contiguous():
            seg = seg.contiguous()
        sp = seg.data_ptr()
    stream = _raw_stream(dev)
    state = _streams.get((dev.index, stream))
    if state is None or state.nbytes < plan.scratch_bytes:
        state = _stream_state(dev, stream, plan.scratch_bytes)
    if size == 1 and C <= SEGSUM_REG_COLS:
        out = _one_slot_output(state, (1,) + shape[1:], dtype, dev)
    else:
        out = torch.empty((size,) + shape[1:], dtype=dtype, device=dev)
    xp = x.data_ptr()
    err = fn(xp, sp, state.tickets, out.data_ptr(), args,
             (xp | sp) % 16 == 0, stream)
    if err:
        _check("dense_segment_sum", err)
    if size == 1:
        launches.add("dense_segment_sum", "dense_segment_sum_one_slot")
    else:
        launches.add("dense_segment_sum")
    return out


def sorted_segment_sum(x: torch.Tensor, seg: torch.Tensor,
                       size: int) -> torch.Tensor:
    """The segment sum of ``dense_segment_sum`` for nondecreasing ids
    ``seg`` (contiguous segments), any number of slots and columns: shape
    ``(size,) + x.shape[1:]``. A row whose id lies outside ``[0, size)``
    is dropped, by the kernel and by the plain version alike. On the card
    one launch a call (``sorted_segment_plan``): each block adds its
    contiguous range of rows in stages (wide rows in slabs of columns), a
    run inside the block in a fixed order (row order in a thread, then a
    scan by segments over the threads), and the last block to finish adds
    the runs that cross blocks in block order; every slot without a row is
    zeroed by the block whose ids surround it, or, for an output large
    beside the rows, by a memset before the launch. Bit-identical from run
    to run. Bound: bytes (each row's id and values read once, the output
    written once)."""
    _segment_args("sorted_segment_sum", x, seg)
    if not _route("sorted_segment_sum", x, seg):
        return segment_sum_reference(x, seg, size)
    shape = x.shape
    n, C = shape[0], (shape[1] if len(shape) == 2 else 1)
    if n == 0 or C == 0:
        return torch.zeros((size,) + shape[1:], dtype=x.dtype,
                           device=x.device)
    plan, args = _sorted_call(n, C, x.element_size(), size)
    return _sorted_launch(x, seg, size, plan.scratch_bytes, args)


def _sorted_launch(x: torch.Tensor, seg: torch.Tensor, size: int,
                   scratch_bytes: int, args: _SortedArgs) -> torch.Tensor:
    """One launch of the sorted kernel on card tensors with the launch
    arguments of a plan, on the current stream's scratch."""
    dtype, dev = x.dtype, x.device
    fn = _launcher("segment_sum", ("sorted", dtype))
    if not x.is_contiguous():
        x = x.contiguous()
    if not seg.is_contiguous():
        seg = seg.contiguous()
    stream = _raw_stream(dev)
    state = _streams.get((dev.index, stream))
    if state is None or state.nbytes < scratch_bytes:
        state = _stream_state(dev, stream, scratch_bytes)
    out = torch.empty((size,) + x.shape[1:], dtype=dtype, device=dev)
    xp, sp = x.data_ptr(), seg.data_ptr()
    err = fn(xp, sp, state.tickets, out.data_ptr(), args, size,
             (xp | sp) % 16 == 0, stream)
    if err:
        _check("sorted_segment_sum", err)
    launches.add("sorted_segment_sum")
    return out
