"""ctypes binding to the native CSV tokenizer (``native/csvparse.cpp``),
ported from ``sparkdq4ml_tpu/frame/native_csv.py``.

The tokenizer parses the all-numeric case, with or without a header record
(the names are read here, the body is skipped natively). Anything else
returns ``None`` and ``frame/csv.py`` reads the file with the Python
engine. The port builds the library itself at first use (:func:`build`):
``g++`` with the flags of ``native/Makefile`` into
``.kernels_build/<hash>/libdqcsv.so``, keyed by the source, the flags and
the target the compiler resolves ``-march=native`` to. It never writes into
``native/``. A build or load failure raises with the compiler's output.

Two native paths, chosen by the ``spark.ingest.*`` settings (``config``):

* **one-shot**: the whole file parses into column-major float64 in one
  call (every file with ``spark.ingest.streaming=false``, else files of at
  most one chunk);
* **streaming**: larger files parse through the ``dq_stream`` API in
  chunks cut on record boundaries, a producer thread running the parse
  (the ctypes call releases the GIL) up to ``spark.ingest.prefetch`` chunks
  ahead. An unquoted file parses into bound host buffers (``pinned``):
  page-locked on the card, from a pool of at most two entries, and each
  column's float rows are copied to the card on a side stream as soon as
  they are known to be float, so the copy of chunk N overlaps the parse of
  chunk N+1. A quoted file takes the per-chunk body (``chunked``), whose
  float64 blocks are narrowed on the host and copied as they arrive.
  Integral columns go over once at the end of the file, as int32.

Every native read appends to :data:`reads`, with the reference's
``ingest.*`` counter names, so a caller can see which path a read took.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import queue
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import config, float_dtype, int_dtype, numpy_dtype
from ..ops.kernels import BUILD_ROOT
from ..utils import faults as _faults
from ..utils.profiling import counters


class NativeIngestError(RuntimeError):
    """The native streaming layer failed mid-read: the prefetch producer
    thread died (its exception rides as ``__cause__``)."""


SOURCE = Path(__file__).resolve().parents[2] / "native" / "csvparse.cpp"
# native/Makefile's CXXFLAGS; -march=native is added where the compiler
# takes it, as the Makefile does.
CXX_FLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-pthread")

_SIMD_CONF = {"auto": -1, "off": 0, "scalar": 0, "avx2": 1, "avx512": 2}
_SIMD_NAMES = {0: "scalar", 1: "avx2", 2: "avx512"}


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _target() -> tuple:
    """(extra flags, the compiler's description of its target): with
    ``-march=native`` when the compiler takes it, whose resolved options
    enter the build key, so that a library built for one CPU is never
    loaded on another."""
    try:
        out = subprocess.run([_cxx(), "-march=native", "-Q", "--help=target"],
                             capture_output=True, text=True, timeout=60)
    except OSError as e:
        raise RuntimeError(f"the native CSV library cannot be built: "
                           f"{_cxx()}: {e}") from e
    if out.returncode == 0:
        return ("-march=native",), out.stdout
    return (), ""


def build_key(flags: tuple, target: str) -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(target.encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``native/csvparse.cpp`` unless its library is built; returns
    the library's path. One process builds while the others wait on a file
    lock; the library lands under a temporary name and is renamed into
    place."""
    extra, target = _target()
    flags = CXX_FLAGS + extra
    out = BUILD_ROOT / build_key(flags, target) / "libdqcsv.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_cxx(), *flags, "-shared", "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"native CSV build failed ({' '.join(cmd)}), exit "
                    f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
    return out


_LIB = None
_LIB_LOCK = threading.Lock()


def _load():
    """The library, built and bound on first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
    return _LIB


def _bind(lib):
    pd = ctypes.POINTER(ctypes.c_double)
    LL, I, P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    oneshot_out = [ctypes.POINTER(pd), ctypes.POINTER(LL),
                   ctypes.POINTER(ctypes.POINTER(ctypes.c_char))]
    path_args = [ctypes.c_char_p, ctypes.c_char, ctypes.c_char, I]
    sigs = {
        "dq_parse_numeric_csv_v2": (LL, path_args + [I, I] + oneshot_out),
        "dq_free": (None, [P]),
        "dq_effective_simd": (I, [I]),
        "dq_stream_open": (P, path_args + [LL, I, I]),
        "dq_stream_ncols": (LL, [P]),
        "dq_stream_simd": (I, [P]),
        "dq_stream_next": (LL, [P, ctypes.POINTER(pd)]),
        "dq_stream_int_flags": (None, [P, ctypes.c_char_p]),
        "dq_stream_close": (None, [P]),
        "dq_stream_total_rows": (LL, [P]),
        "dq_stream_bind": (I, [P, P, P, LL, I]),
        "dq_stream_next_into": (LL, [P, ctypes.POINTER(LL)]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def available() -> bool:
    """True once the library is built and loaded (a failure raises)."""
    return _load() is not None


def streaming_available() -> bool:
    """True when the library carries the dq_stream ABI (the port builds it
    from the current source, so always once it loads)."""
    return hasattr(_load(), "dq_stream_open")


def simd_level(requested: Optional[str] = None) -> str:
    """The SIMD tier a parse would run for a request (default: the
    ``spark.ingest.simd`` setting)."""
    req = _SIMD_CONF.get((requested or config.ingest_simd).lower(), -1)
    return _SIMD_NAMES.get(int(_load().dq_effective_simd(req)), "scalar")


# ---- the read record --------------------------------------------------------

COUNTERS = ("ingest.files", "ingest.streamed", "ingest.bytes",
            "ingest.rows", "ingest.chunks", "ingest.python_fallback")


class ReadRecord:
    """The last reads (engine, mode, bytes, rows, chunks, threads, SIMD
    verdict, seconds) and running ``ingest.*`` counters."""

    def __init__(self, keep: int = 16):
        self._lock = threading.Lock()
        self._reads = collections.deque(maxlen=keep)
        self._counters = dict.fromkeys(COUNTERS, 0)

    def add(self, read: dict) -> None:
        with self._lock:
            self._reads.append(dict(read))
            if read["engine"] == "python":
                if read.get("declined"):
                    self._counters["ingest.python_fallback"] += 1
                return
            self._counters["ingest.files"] += 1
            self._counters["ingest.bytes"] += read["bytes"]
            self._counters["ingest.rows"] += read["rows"]
            self._counters["ingest.chunks"] += read["chunks"]
            if read["mode"] != "oneshot":
                self._counters["ingest.streamed"] += 1

    def last(self) -> Optional[dict]:
        with self._lock:
            return dict(self._reads[-1]) if self._reads else None

    def snapshot(self) -> dict:
        with self._lock:
            return {"reads": [dict(r) for r in self._reads],
                    "counters": dict(self._counters)}

    def reset(self) -> None:
        with self._lock:
            self._reads.clear()
            self._counters = dict.fromkeys(COUNTERS, 0)


reads = ReadRecord()


def _record(path, mode, size, rows, chunks, t0, simd, device, copies):
    seconds = time.perf_counter() - t0
    reads.add({"engine": "native", "mode": mode,
               "path": os.path.basename(path), "bytes": int(size),
               "rows": int(rows), "chunks": int(chunks),
               "threads": config.ingest_threads,
               "prefetch": config.ingest_prefetch if mode != "oneshot"
               else 0, "simd": simd, "seconds": seconds,
               "gb_s": size / seconds / 1e9 if seconds > 0 else 0.0,
               "device": str(device), "copies": copies})


# ---- the read ---------------------------------------------------------------

def try_read_csv(path: str, header: bool, infer_schema: bool, delimiter: str,
                 quote: str = '"', required: bool = False, device=None):
    """Native read into a Frame on ``device`` (default: the resolved
    device), or None when the Python engine must read the file."""
    from ..config import resolve_device

    device = resolve_device(device)
    lib = _load()
    if len(delimiter.encode("utf-8")) != 1 or \
            len(quote.encode("utf-8")) != 1:
        return None  # c_char takes exactly one byte
    if not infer_schema:
        # the native path covers the inferred all-numeric shape only
        if required:
            raise RuntimeError("native CSV engine only supports "
                               "infer_schema=True")
        return None
    names = None
    if header:
        names = _read_header_names(path, delimiter, quote)
        if names is None:
            return None
    # the fault site: a due io_error raises InjectedIOError here (a flaky
    # disk), which frame/csv.py degrades to the Python engine
    _faults.inject("ingest_native")
    try:
        size = os.path.getsize(path)
    except OSError:
        raise FileNotFoundError(path) from None
    if config.ingest_streaming and size > config.ingest_chunk_bytes:
        return _stream_read(lib, path, size, names, header, delimiter, quote,
                            device)
    return _oneshot_read(lib, path, size, names, header, delimiter, quote,
                         device)


def _names(names, nc):
    return list(names) if names is not None else [f"_c{j}" for j in
                                                   range(nc)]


def _oneshot_read(lib, path, size, names, header, delimiter, quote, device):
    """Whole-file native parse with the SIMD and thread settings."""
    data_p = ctypes.POINTER(ctypes.c_double)()
    ncols = ctypes.c_longlong(0)
    intf_p = ctypes.POINTER(ctypes.c_char)()
    t0 = time.perf_counter()
    nrows = lib.dq_parse_numeric_csv_v2(
        path.encode(), delimiter.encode(), quote.encode(), 1 if header else 0,
        _SIMD_CONF.get(config.ingest_simd.lower(), -1), config.ingest_threads,
        ctypes.byref(data_p), ctypes.byref(ncols), ctypes.byref(intf_p))
    frame = _finish_oneshot(lib, path, nrows, data_p, ncols, intf_p, names,
                            device)
    if frame is not None and nrows > 0:
        _record(path, "oneshot", size, nrows, 1, t0, simd_level(), device,
                "pageable" if device.type == "cuda" else "none")
    return frame


def _finish_oneshot(lib, path, nrows, data_p, ncols, intf_p, names, device):
    from .frame import Frame

    if nrows < 0:
        if nrows == -2:
            raise FileNotFoundError(path)
        return None  # non-numeric content: the Python engine
    data = {}
    try:
        nc = ncols.value
        if names is not None and len(names) != nc:
            return None  # ragged header against the body
        if nc == 0 or nrows == 0:
            # a header-only file takes the Python engine's exact typing
            return None if names else Frame({}, device=device)
        # astype copies out of the C buffer before it is freed
        cols = np.ctypeslib.as_array(data_p, shape=(nc * nrows,)).reshape(
            nc, nrows)
        flags = bytes(ctypes.cast(
            intf_p, ctypes.POINTER(ctypes.c_char * nc)).contents)
        for j, name in enumerate(_names(names, nc)):
            dt = int_dtype() if flags[j] else float_dtype()
            data[name] = torch.from_numpy(
                cols[j].astype(numpy_dtype(dt))).to(device)
    finally:
        lib.dq_free(data_p)
        lib.dq_free(intf_p)
    return Frame(data, device=device)


# ---- bind buffers -----------------------------------------------------------
# On the card the bind buffers are page-locked host tensors, so that the
# copies to the card are asynchronous DMA. Pinning a hundred megabytes is
# slow the first time, so finished buffers go back to a pool once the
# copies that read them have ended. On the CPU the columns are views of the
# buffers themselves (the reference's "alias" rule), so those buffers never
# return to the pool.
_POOL_LOCK = threading.Lock()
_POOL: list = []  # (float buffer, int32 buffer) pairs
_POOL_MAX_ENTRIES = 2
_POOL_CAP_BYTES = 1 << 30


def _pool_checkout(nf: int, fdtype: torch.dtype, ni: int, pinned: bool):
    if pinned:
        with _POOL_LOCK:
            for k, (f, i) in enumerate(_POOL):
                if f.dtype == fdtype and f.numel() >= nf and \
                        i.numel() >= ni:
                    del _POOL[k]
                    return f, i
    return (torch.empty(nf, dtype=fdtype, pin_memory=pinned),
            torch.empty(ni, dtype=torch.int32, pin_memory=pinned))


def _pool_checkin(fbuf: torch.Tensor, ibuf: torch.Tensor) -> None:
    if not fbuf.is_pinned():
        return  # the CPU's columns alias the buffers
    if fbuf.nbytes + ibuf.nbytes > _POOL_CAP_BYTES:
        return
    with _POOL_LOCK:
        if len(_POOL) < _POOL_MAX_ENTRIES:
            _POOL.append((fbuf, ibuf))


class _Copier:
    """Copies host slices to the card on a side stream. Device columns are
    allocated on the current stream, which the side stream waits for before
    it writes them; :meth:`finish` makes the current stream wait for every
    copy and returns the event to synchronise on before a host buffer that
    a copy reads is reused."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def empty(self, rows: int, dtype: torch.dtype) -> torch.Tensor:
        out = torch.empty(rows, dtype=dtype, device=self.device)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        return out

    def copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        with torch.cuda.stream(self.stream):
            dst.copy_(src, non_blocking=True)

    def upload(self, src: torch.Tensor) -> torch.Tensor:
        dst = self.empty(src.numel(), src.dtype)
        self.copy(dst, src)
        return dst

    def finish(self) -> torch.cuda.Event:
        done = torch.cuda.Event()
        done.record(self.stream)
        torch.cuda.current_stream(self.device).wait_event(done)
        return done


def _stream_read(lib, path, size, names, header, delimiter, quote, device):
    """Streaming native read into device columns: the bind body
    (``pinned``) for an unquoted file, the per-chunk body (``chunked``)
    for a quoted one or a refused bind."""
    from .frame import Frame

    simd = _SIMD_CONF.get(config.ingest_simd.lower(), -1)
    t0 = time.perf_counter()
    h = lib.dq_stream_open(path.encode(), delimiter.encode(), quote.encode(),
                           1 if header else 0, config.ingest_chunk_bytes,
                           config.ingest_threads, simd)
    if not h:
        raise FileNotFoundError(path)
    try:
        nc = int(lib.dq_stream_ncols(h))
        if nc < 0:
            return None  # non-numeric prologue
        if names is not None and len(names) != nc:
            return None  # ragged header against the body
        if nc == 0:
            return None if names else Frame({}, device=device)
        verdict = _SIMD_NAMES.get(int(lib.dq_stream_simd(h)), "scalar")
        total_cap = int(lib.dq_stream_total_rows(h))  # -1: quoted file
        out = None
        if total_cap >= 0:
            out = _stream_pinned(lib, h, nc, total_cap, device)
        if out is None:
            out = _stream_chunked(lib, h, nc, device)
        if out is False:
            return None  # non-numeric content mid-file
        cols, total_rows, nchunks, mode, copies = out
    finally:
        lib.dq_stream_close(h)
    _record(path, mode, size, total_rows, nchunks, t0, verdict, device,
            copies)
    return Frame(dict(zip(_names(names, nc), cols)), device=device)


def _stream_pinned(lib, h, nc, total_cap, device):
    """The bind body: chunks parse straight into their rows of two bound
    host buffers (floats, int32 staging). Returns ``(columns, rows,
    chunks, "pinned", the copies' source memory)``, False for non-numeric
    content, or None when the bind is refused (the caller takes the
    per-chunk body)."""
    fdt = float_dtype()
    on_card = device.type == "cuda"
    # Column stride padded to 16 elements, so that each column of both
    # buffers starts 64-byte aligned.
    stride = ((max(total_cap, 1) + 15) // 16) * 16
    # a due pool_exhaust fault: the bind pool is out of buffers, and the
    # read takes the per-chunk body instead
    if _faults.fired("ingest_native", "pool_exhaust"):
        from ..utils.recovery import RECOVERY_LOG

        RECOVERY_LOG.record(
            "ingest_native", "fallback", rung="chunked",
            cause="pool exhausted",
            detail="bind-buffer pool exhausted; chunked stream body")
        counters.increment("ingest.fault_fallback")
        return None
    fbuf, ibuf = _pool_checkout(nc * stride, fdt, nc * stride,
                                pinned=on_card)
    rc = int(lib.dq_stream_bind(h, ctypes.c_void_p(fbuf.data_ptr()),
                                ctypes.c_void_p(ibuf.data_ptr()), stride,
                                1 if fdt == torch.float64 else 0))
    if rc != 0:
        _pool_checkin(fbuf, ibuf)
        return None
    # On the card a column's float rows are copied as soon as they are
    # known to be float. While a column's integral flag is alive only its
    # int32 lane is written; when the flag dies, the native backfill has
    # completed the float lane for every row so far before the chunk call
    # returns, and rows [0, total) go over at once; then chunk by chunk.
    # No copied region is rewritten: the backfill only targets columns
    # whose flag dies, which have had no float rows copied. Columns still
    # integral at the end go over as int32. On the CPU each column is a
    # view of its buffer at the end.
    copier = _Copier(device) if on_card else None
    done = None
    chunks = _bind_chunk_iter(lib, h, nc)
    try:
        dev_cols: list = [None] * nc
        dev_rows = [0] * nc  # float rows already copied, per column
        total_rows = nchunks = 0
        for rows, (_, chunk_flags) in chunks:
            if rows == -2:
                raise MemoryError("native CSV stream allocation failure")
            if rows < 0:
                return False
            nchunks += 1
            total_rows += rows
            if copier is None:
                continue
            for j in range(nc):
                if chunk_flags[j]:
                    continue  # the int32 lane is live: floats unwritten
                if dev_cols[j] is None:
                    dev_cols[j] = copier.empty(total_cap, fdt)
                base = j * stride
                copier.copy(dev_cols[j][dev_rows[j]:total_rows],
                            fbuf[base + dev_rows[j]:base + total_rows])
                dev_rows[j] = total_rows
        flags = _stream_flags(lib, h, nc)
        cols = []
        for j in range(nc):
            base = j * stride
            if flags[j]:
                col = ibuf[base:base + total_rows]
                cols.append(copier.upload(col) if copier else col)
            elif copier is not None:
                cols.append(dev_cols[j][:total_rows])
            else:
                cols.append(fbuf[base:base + total_rows])
        copies = "none"
        if copier is not None:
            # the casts below run on the current stream: after the copies
            done = copier.finish()
            copies = "pinned" if fbuf.is_pinned() else "pageable"
        cols = [c.to(int_dtype()) if flags[j] else c
                for j, c in enumerate(cols)]
        return cols, total_rows, nchunks, "pinned", copies
    finally:
        # Stop the producer before the buffers can be reused: it may still
        # be parsing into them after a failure on this side. Then wait for
        # the copies that read them.
        chunks.close()
        if done is not None:
            done.synchronize()
            _pool_checkin(fbuf, ibuf)
        elif copier is not None:
            torch.cuda.synchronize(device)
            _pool_checkin(fbuf, ibuf)


def _stream_chunked(lib, h, nc, device):
    """The per-chunk body: each chunk arrives as a column-major float64
    block, narrowed on the host (into page-locked staging on the card,
    copied there at once); integral columns stage the int32 the one-shot
    read would give. Returns ``(columns, rows, chunks, "chunked", the
    copies' source memory)`` or False for non-numeric content."""
    fdt, idt = float_dtype(), int_dtype()
    np_f, np_i = numpy_dtype(fdt), numpy_dtype(idt)
    copier = _Copier(device) if device.type == "cuda" else None
    float_chunks: list = [[] for _ in range(nc)]
    int_chunks: list = [[] for _ in range(nc)]  # None once integrality broke
    staged = []  # page-locked sources of copies still in flight
    total_rows = nchunks = 0
    for rows, data_p in _chunk_iter(lib, h):
        if rows == -2:
            raise MemoryError("native CSV stream allocation failure")
        if rows < 0:
            return False
        nchunks += 1
        cols = np.ctypeslib.as_array(data_p, shape=(nc * rows,)).reshape(
            nc, rows)
        flags = _stream_flags(lib, h, nc)
        try:
            for j in range(nc):
                if copier is None:
                    float_chunks[j].append(cols[j].astype(np_f))
                else:
                    stage = torch.empty(rows, dtype=fdt, pin_memory=True)
                    stage.numpy()[:] = cols[j]
                    staged.append(stage)
                    float_chunks[j].append(copier.upload(stage))
                if int_chunks[j] is None:
                    continue
                if flags[j]:
                    int_chunks[j].append(cols[j].astype(np_i))
                else:
                    int_chunks[j] = None
        finally:
            lib.dq_free(data_p)
        total_rows += rows
    flags = _stream_flags(lib, h, nc)
    out = []
    for j in range(nc):
        if flags[j] and int_chunks[j] is not None:
            col = torch.from_numpy(np.concatenate(int_chunks[j]))
            out.append(copier.upload(col) if copier else col)
        elif copier is not None:
            out.append(float_chunks[j])
        else:
            out.append(torch.from_numpy(np.concatenate(float_chunks[j])))
    if copier is not None:
        # the concatenations below run on the current stream: after the
        # copies; the staging buffers go once the copies have ended
        copier.finish().synchronize()
        out = [torch.cat(c) if isinstance(c, list) else c for c in out]
    del staged
    return (out, total_rows, nchunks, "chunked",
            "none" if copier is None else "pinned staging")


def _stream_flags(lib, h, nc) -> bytes:
    buf = ctypes.create_string_buffer(nc)
    lib.dq_stream_int_flags(h, buf)
    return buf.raw[:nc]


#: Queue code of a dead producer; its payload is the exception (the native
#: layer's own codes stop at -2).
_PRODUCER_ERROR = -3


def _prefetch_iter(next_chunk, release=None):
    """Yield ``(rows, payload)`` chunks from ``next_chunk()``.

    With ``spark.ingest.prefetch`` > 0 a producer thread runs the native
    parse up to that many chunks ahead (a bounded queue). A terminal code
    below 0 is yielded too, so that the consumer owns the error handling.
    Closing the iterator stops the producer, releases every chunk it could
    not hand over (``release(payload)``) and joins it. A producer that
    dies hands its exception through the queue, raised here as
    :class:`NativeIngestError`; the consumer's waits are timed and probe
    the thread, so a producer lost without a handoff raises too.
    """
    depth = config.ingest_prefetch
    if depth <= 0:  # no thread: parse inline
        while True:
            rows, payload = next_chunk()
            if rows <= 0:
                if rows < 0:
                    yield rows, payload
                return
            yield rows, payload
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def produce():
        while True:
            try:
                if _faults.fired("ingest_native", "thread_death"):
                    raise RuntimeError("injected prefetch-producer death")
                item = next_chunk()
            except BaseException as e:  # handed to the consumer, raised there
                item = (_PRODUCER_ERROR, e)
            rows, payload = item
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    break
                except queue.Full:
                    continue
            else:  # the consumer is gone: release the orphaned chunk
                if rows > 0 and release is not None:
                    release(payload)
                return
            if rows <= 0:
                return

    t = threading.Thread(target=produce, name="dqcsv-prefetch", daemon=True)
    t.start()
    try:
        while True:
            while True:
                try:
                    rows, payload = q.get(timeout=0.5)
                    break
                except queue.Empty:
                    if not t.is_alive():
                        # the last item may have landed after the timeout
                        try:
                            rows, payload = q.get_nowait()
                            break
                        except queue.Empty:
                            raise NativeIngestError(
                                "prefetch producer thread died without "
                                "handing off a chunk") from None
            if rows == _PRODUCER_ERROR:
                raise NativeIngestError(
                    f"prefetch producer thread died: {payload!r}"
                ) from payload
            if rows <= 0:
                if rows < 0:
                    yield rows, payload
                return
            yield rows, payload
    finally:
        # The producer's puts time out and test ``stop``, so it ends without
        # a drain; draining after the join releases every chunk it queued
        # (a drain before the join would miss one it puts meanwhile).
        stop.set()
        t.join()
        while True:
            try:
                rows, payload = q.get_nowait()
            except queue.Empty:
                break
            if rows > 0 and release is not None:
                release(payload)


def _chunk_iter(lib, h):
    """``(rows, data pointer)`` chunks: blocks the consumer (or the
    iterator, on teardown) frees with ``dq_free``."""
    def next_chunk():
        data_p = ctypes.POINTER(ctypes.c_double)()
        rows = int(lib.dq_stream_next(h, ctypes.byref(data_p)))
        if rows > 0 and _faults.fired("ingest_native", "torn_chunk"):
            # a torn chunk: the parse is discarded and the native layer's
            # error raised (engine "auto" degrades, "native" raises)
            lib.dq_free(data_p)
            raise NativeIngestError("injected short-read/torn chunk")
        return rows, (data_p if rows > 0 else None)

    return _prefetch_iter(next_chunk, release=lib.dq_free)


def _bind_chunk_iter(lib, h, nc):
    """``(rows, (row offset, flags))`` of the bind stream. ``flags`` are
    the integral flags as of the end of this chunk, read in the producer:
    with prefetch it may already be parsing, and backfilling, later chunks
    while the consumer handles this one, so a flag read by the consumer
    would race those writes. Once a column's flag is dead in the snapshot
    after chunk k, its float rows [0, rows_k) are final."""
    def next_chunk():
        off = ctypes.c_longlong(0)
        rows = int(lib.dq_stream_next_into(h, ctypes.byref(off)))
        if rows > 0 and _faults.fired("ingest_native", "torn_chunk"):
            # a torn chunk in the bind body: the rows written are
            # abandoned (the buffers go back once the producer stops)
            raise NativeIngestError("injected short-read/torn chunk")
        flags = _stream_flags(lib, h, nc) if rows > 0 else b""
        return rows, (off.value if rows > 0 else 0, flags)

    return _prefetch_iter(next_chunk)


# ---- header and record helpers ----------------------------------------------

def _read_header_names(path: str, delimiter: str, quote: str):
    """The first non-blank record's fields, read with the Python engine's
    scanner, or None when the header cannot be read with confidence (the
    read then takes the Python engine):

    - undecodable bytes, or no complete first record inside the 64 KiB
      probe (an unquoted record end proves it complete);
    - the Python engine and the native prologue would pick different
      header records: Python's blank-record test is ``str.strip()`` (any
      Unicode space), the native one space and tab only.

    When the file continues past the probe, the probe is cut at its last
    record separator before decoding (separators are ASCII, so the cut
    never splits a UTF-8 character).
    """
    try:
        with open(path, "rb") as f:
            chunk = f.read(1 << 16)
            more = f.read(1) != b""
    except OSError:
        return None
    if more:
        cut = max(chunk.rfind(b"\n"), chunk.rfind(b"\r"))
        if cut < 0:
            return None
        chunk = chunk[:cut + 1]
    try:
        text = chunk.decode("utf-8")
    except UnicodeDecodeError:
        return None
    if more and not _has_unquoted_record_end(text, quote):
        return None
    from .csv import parse_csv_text, split_fields

    rows = parse_csv_text(text, delimiter, quote)
    if not rows:
        return None
    c_first = next((rec for rec in _plain_records(text)
                    if rec.strip(" \t") != ""), None)
    if c_first is None or split_fields(c_first, delimiter, quote) != rows[0]:
        return None
    return list(rows[0])


def _plain_records(text: str):
    """Records split on \\r\\n, \\r and \\n with no quote awareness: the
    native prologue's view of the file."""
    rec = []
    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        if ch == "\n" or ch == "\r":
            yield "".join(rec)
            rec = []
            if ch == "\r" and i + 1 < n and text[i + 1] == "\n":
                i += 1
        else:
            rec.append(ch)
        i += 1
    if rec:
        yield "".join(rec)


def _has_unquoted_record_end(text: str, quote: str) -> bool:
    """True when ``text`` holds a record end outside quotes (RFC 4180: a
    separator inside quotes does not end a record)."""
    in_quotes = False
    for ch in text:
        if ch == quote:
            in_quotes = not in_quotes
        elif (ch == "\n" or ch == "\r") and not in_quotes:
            return True
    return False
