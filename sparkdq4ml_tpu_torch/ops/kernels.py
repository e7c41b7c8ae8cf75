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
import hashlib
import math
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

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
# The dense segment sum's plan: contiguous row ranges of at least this many
# rows, at most SEGSUM_MAX_BLOCKS of them (eight an SM: on the card 1056
# blocks took half the time of 264 at 9.6 M rows, and 2112 more), and
# per-warp tables of at most SEGSUM_SMEM_BYTES of shared memory a block
# (eight warps, each with a table and 32 rows of staging); a larger table
# takes the sorted kernel after a stable sort of the slot ids
# (ops/segments.py).
SEGSUM_MIN_ROWS_PER_BLOCK = 4096
SEGSUM_MAX_BLOCKS = 1056
SEGSUM_WARPS = 8
SEGSUM_SMEM_BYTES = 96 << 10
# Rows a thread of the sorted kernel sums in row order. The kernels read
# SEGSUM_WARPS and SEGSUM_TILE from the nvcc flags below.
SEGSUM_TILE = 32
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC",
              f"-DGRAM_SMALL_MAX_D={GRAM_SMALL_MAX_D}",
              f"-DGRAM_TILE={GRAM_TILE}", f"-DSEGSUM_WARPS={SEGSUM_WARPS}",
              f"-DSEGSUM_TILE={SEGSUM_TILE}")
# Partial Gramians of stage 1 stay under this many bytes (about 2 MB a
# chunk at D = 514 in float64, so at most 15 chunks there).
GRAM_PARTIAL_BYTES = 32 << 20
GRAM_MAX_CHUNKS = 1024
GRAM_MIN_ROWS_PER_CHUNK = 256


class LaunchCounts:
    """How many times each wrapper launched its kernel. A call that runs
    the plain version, or launches nothing (n = 0), does not count."""

    def __init__(self):
        self._counts = dict.fromkeys(KERNELS, 0)
        self._lock = threading.Lock()

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1

    def reset(self) -> None:
        with self._lock:
            self._counts = dict.fromkeys(KERNELS, 0)

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
                   [P, P, P, P, LL, I, I, I, LL, P]),
                  ({("sorted", f32): lib.sorted_segment_sum_f32,
                    ("sorted", f64): lib.sorted_segment_sum_f64},
                   [P, P, P, P, P, P, P, LL, I, LL, P])]
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
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    dev = devices.pop()
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
    """Plain version of both segment sums: ``index_add_`` into zeros."""
    out = torch.zeros((size,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg, x)


def dense_segment_fits(size: int, columns: int, elem_bytes: int) -> bool:
    """True when the dense kernel's per-warp tables of ``size`` slots and
    ``columns`` columns, with their staging rows, fit its shared memory."""
    return (SEGSUM_WARPS * (size + 32) * columns * elem_bytes
            <= SEGSUM_SMEM_BYTES)


def dense_segment_plan(n: int) -> tuple[int, int]:
    """``(blocks, rows_per_block)`` of the dense kernel for n >= 1 rows
    (n = 0 launches nothing): contiguous row
    ranges of at least ``SEGSUM_MIN_ROWS_PER_BLOCK`` rows, at most
    ``SEGSUM_MAX_BLOCKS`` of them, no empty one. The summation order
    follows from it, so it depends on n alone."""
    blocks = max(1, min(SEGSUM_MAX_BLOCKS, n // SEGSUM_MIN_ROWS_PER_BLOCK))
    rows = -(-n // blocks)
    return -(-n // rows), rows


def _segment_args(name: str, x: torch.Tensor, seg: torch.Tensor):
    if x.ndim not in (1, 2) or seg.shape != x.shape[:1] \
            or seg.dtype != torch.int64:
        raise ValueError(f"{name}: x must be (n,) or (n, C) and seg an "
                         "int64 (n,) tensor")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: x must be float32 or float64")


def dense_segment_sum(x: torch.Tensor, seg: torch.Tensor,
                      size: int) -> torch.Tensor:
    """``out[s] = Σ x[i] over seg[i] == s`` for slot ids ``seg`` in
    ``[0, size)`` in any order: shape ``(size,) + x.shape[1:]``. On the
    card the order of the adds is fixed by ``dense_segment_plan``, so the
    result is bit-identical from run to run; the table must pass
    ``dense_segment_fits``."""
    _segment_args("dense_segment_sum", x, seg)
    if not _route("dense_segment_sum", x, seg):
        return segment_sum_reference(x, seg, size)
    n = x.shape[0]
    x2 = (x if x.ndim == 2 else x[:, None]).contiguous()
    C = x2.shape[1]
    if not dense_segment_fits(size, C, x.element_size()):
        raise ValueError(f"dense_segment_sum: a table of {size} slots and "
                         f"{C} columns does not fit shared memory")
    shape = (size,) + tuple(x.shape[1:])
    if n == 0 or C == 0:
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    fn = _launcher("segment_sum", ("dense", x.dtype))
    seg = seg.contiguous()
    out = torch.empty((size, C), dtype=x.dtype, device=x.device)
    blocks, rows = dense_segment_plan(n)
    part = (torch.empty((blocks, size, C), dtype=x.dtype, device=x.device)
            if blocks > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check("dense_segment_sum", fn(x2.data_ptr(), seg.data_ptr(),
                                   _ptr(part), out.data_ptr(), n, C, size,
                                   blocks, rows, stream))
    launches.add("dense_segment_sum")
    return out.reshape(shape)


def sorted_segment_sum(x: torch.Tensor, seg: torch.Tensor,
                       size: int) -> torch.Tensor:
    """The segment sum of ``dense_segment_sum`` for nondecreasing ids
    ``seg`` in ``[0, size)`` (contiguous segments), any number of them.
    Each segment is summed in row order inside fixed tiles of rows, then
    over its tiles in a fixed order: bit-identical from run to run."""
    _segment_args("sorted_segment_sum", x, seg)
    if not _route("sorted_segment_sum", x, seg):
        return segment_sum_reference(x, seg, size)
    n = x.shape[0]
    x2 = (x if x.ndim == 2 else x[:, None]).contiguous()
    C = x2.shape[1]
    out = torch.zeros((size, C), dtype=x.dtype, device=x.device)
    if n == 0 or C == 0:
        return out.reshape((size,) + tuple(x.shape[1:]))
    fn = _launcher("segment_sum", ("sorted", x.dtype))
    seg = seg.contiguous()
    tiles = -(-n // SEGSUM_TILE)
    head = torch.empty((tiles, C), dtype=x.dtype, device=x.device)
    tail = torch.empty((tiles, C), dtype=x.dtype, device=x.device)
    # the tiles where a segment that goes on past them starts, and their
    # number (an integer counter)
    owners = torch.empty(tiles, dtype=torch.int32, device=x.device)
    n_owners = torch.zeros(1, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check("sorted_segment_sum", fn(x2.data_ptr(), seg.data_ptr(),
                                    head.data_ptr(), tail.data_ptr(),
                                    owners.data_ptr(), n_owners.data_ptr(),
                                    out.data_ptr(), n, C, size, stream))
    launches.add("sorted_segment_sum")
    return out.reshape((size,) + tuple(x.shape[1:]))
