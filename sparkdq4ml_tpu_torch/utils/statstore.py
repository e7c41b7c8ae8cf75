"""Plan-statistics observatory (the port of
``sparkdq4ml_tpu/utils/statstore.py``, single device): the store the
pipeline compiler's observations accumulate into, keyed by the structural
plan key (literals hoisted, row counts bucketed away). Plan keys are the
JAX package's strings, letter for letter, so a snapshot written by either
package loads into the other and its entries match.

What accumulates per key (:class:`KeyStats`):

* **selectivity**: observed input row slots against observed valid output
  rows. The output count is a deferred device reduction (a flush keeps
  ``sum(mask)`` as a device scalar; :meth:`StatStore.drain_pending` pulls
  every pending scalar in one batched, counted read on the cold paths:
  report, save, stop), never a host read on the flush path;
* **wall-ms / compile-ms digests**: fixed-bucket histograms
  (:class:`Digest`) of the flush's host time, hits and first runs
  apart. CUDA launches are asynchronous, so on the card
  this is the host path of a flush, not its device time;
* **host syncs, est/measured peak bytes**.

Persistence (``spark.stats.path``): an atomic, versioned JSONL snapshot,
a header line with ``version``/``saved_at`` and one entry per line,
written to a temporary file promoted by ``os.replace``. ``save(merge=True)``
merges the file's entries first (per key, the entry with more evidence
wins). A corrupt or version-skewed file degrades to an empty store with a
``stats.load_failed`` count and a warning; the fault-injection sites and
the recovery log come with ``utils/faults.py`` and ``utils/recovery.py``.

``spark.stats.enabled=false`` reduces every producer hook to one flag
read.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

from ..config import config
from . import profiling

logger = logging.getLogger("sparkdq4ml_tpu_torch.statstore")

#: Snapshot schema version — a mismatched file is STALE (the entry
#: layout may have changed) and degrades to empty with a recovery event.
SCHEMA_VERSION = 1

#: Wall/compile-time digest bucket bounds (milliseconds). Fixed at
#: module level so persisted digests from different sessions always
#: merge bucket-for-bucket.
DIGEST_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                     100.0, 250.0, 500.0, 1000.0, 2500.0, 10000.0)

#: Bound on not-yet-drained deferred selectivity scalars (each is one
#: 0-d device array): past it the oldest observation is dropped and
#: counted, never an unbounded device-buffer leak.
MAX_PENDING = 4096


def _pull_scalars(scalars) -> list:
    """Host ints of device scalars (0-dim tensors, or count vectors whose
    sum is the count), one stacked read per device; plain numbers pass
    through."""
    import torch

    out: list = [None] * len(scalars)
    by_device: dict = {}
    for i, v in enumerate(scalars):
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append(i)
        else:
            out[i] = int(v)
    for idx in by_device.values():
        stacked = torch.stack([scalars[i].reshape(-1).sum() for i in idx])
        for i, v in zip(idx, stacked.cpu().tolist()):
            out[i] = int(v)
    return out


class Digest:
    """Fixed-bucket latency digest — the persistable cousin of the
    observability :class:`~.observability.Histogram`: same cumulative
    semantics, plus ``merge`` and a JSON document form so per-key
    distributions survive sessions. Thread-safety is the owning store's
    job (every mutation happens under the store lock)."""

    __slots__ = ("counts", "sum", "count", "max")

    def __init__(self):
        self.counts = [0] * (len(DIGEST_BUCKETS_MS) + 1)  # +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.max = 0.0

    def observe(self, value_ms: float) -> None:
        v = float(value_ms)
        i = len(DIGEST_BUCKETS_MS)
        for j, b in enumerate(DIGEST_BUCKETS_MS):
            if v <= b:
                i = j
                break
        self.counts[i] += 1
        self.sum += v
        self.count += 1
        if v > self.max:
            self.max = v

    def merge(self, other: "Digest") -> None:
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        self.max = max(self.max, other.max)

    def mean(self) -> Optional[float]:
        return (self.sum / self.count) if self.count else None

    def quantile(self, q: float) -> Optional[float]:
        """Upper-bound estimate of the ``q`` quantile (the bucket upper
        edge the rank lands in; ``max`` for the overflow bucket)."""
        if not self.count:
            return None
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank and c:
                return (DIGEST_BUCKETS_MS[i]
                        if i < len(DIGEST_BUCKETS_MS) else self.max)
        return self.max

    # Named quantile accessors — THE numbers the cost model
    # (sql/optimizer.py, still to port) and stats_report() both read, so bucket math is derived in exactly one place.
    def p50(self) -> Optional[float]:
        return self.quantile(0.5)

    def p90(self) -> Optional[float]:
        return self.quantile(0.9)

    def to_doc(self) -> dict:
        return {"counts": list(self.counts), "sum": self.sum,
                "count": self.count, "max": self.max}

    @classmethod
    def from_doc(cls, doc: dict) -> "Digest":
        d = cls()
        counts = doc.get("counts") or []
        if len(counts) != len(d.counts):
            raise ValueError("digest bucket-count mismatch")
        d.counts = [int(c) for c in counts]
        d.sum = float(doc.get("sum", 0.0))
        d.count = int(doc.get("count", 0))
        d.max = float(doc.get("max", 0.0))
        return d


class KeyStats:
    """Running statistics for ONE structural plan key. ``rows_in`` /
    ``rows_out`` accumulate only over flushes whose output count was
    actually observed (``sel_observations``), so the selectivity ratio is
    never diluted by flushes that were dispatched but never counted."""

    __slots__ = ("key", "kind", "flushes", "compiles", "rows_in",
                 "rows_out", "sel_observations", "wall_ms", "compile_ms",
                 "host_syncs", "est_bytes_max", "peak_bytes_max",
                 "cost", "profile", "updated_at")

    def __init__(self, key: str, kind: str):
        self.key = key
        self.kind = kind
        self.flushes = 0
        self.compiles = 0
        self.rows_in = 0
        self.rows_out = 0
        self.sel_observations = 0
        self.wall_ms = Digest()
        self.compile_ms = Digest()
        self.host_syncs = 0
        self.est_bytes_max = 0
        self.peak_bytes_max = 0
        # AOT cost profile (utils/costprof.py CostProfile.to_doc():
        # flops / bytes / per-collective bytes / generated-code peak) —
        # structural per key, so one extraction serves every session
        # that loads this snapshot. None until an extraction lands.
        self.cost: Optional[dict] = None
        # DQ column-profile snapshot (utils/dqprof.py
        # ColumnProfile.to_doc(): versioned sketch fields + fixed-bucket
        # histogram) under ``dqprof|<column>`` keys — the cross-session
        # drift baseline. None until a profile drain lands. Optional
        # field: pre-dq snapshots load unchanged (back-compatible).
        self.profile: Optional[dict] = None
        self.updated_at = 0.0

    @property
    def selectivity(self) -> Optional[float]:
        """Observed valid-rows-out per row-slot-in (None until at least
        one output count landed; an all-filtered history reads 0.0)."""
        if not self.sel_observations or self.rows_in <= 0:
            return None
        return self.rows_out / self.rows_in

    def observations(self) -> int:
        """Total evidence weight — the merge tiebreaker."""
        return self.flushes + self.sel_observations + self.wall_ms.count

    def merge(self, other: "KeyStats") -> None:
        self.flushes += other.flushes
        self.compiles += other.compiles
        self.rows_in += other.rows_in
        self.rows_out += other.rows_out
        self.sel_observations += other.sel_observations
        self.wall_ms.merge(other.wall_ms)
        self.compile_ms.merge(other.compile_ms)
        self.host_syncs += other.host_syncs
        self.est_bytes_max = max(self.est_bytes_max, other.est_bytes_max)
        self.peak_bytes_max = max(self.peak_bytes_max, other.peak_bytes_max)
        if self.cost is None:
            self.cost = other.cost
        if self.profile is None:
            self.profile = other.profile
        self.updated_at = max(self.updated_at, other.updated_at)

    def to_doc(self) -> dict:
        doc = {
            "key": self.key, "kind": self.kind, "flushes": self.flushes,
            "compiles": self.compiles, "rows_in": self.rows_in,
            "rows_out": self.rows_out,
            "sel_observations": self.sel_observations,
            "wall_ms": self.wall_ms.to_doc(),
            "compile_ms": self.compile_ms.to_doc(),
            "host_syncs": self.host_syncs,
            "est_bytes_max": self.est_bytes_max,
            "peak_bytes_max": self.peak_bytes_max,
            "updated_at": self.updated_at,
        }
        if self.cost is not None:
            doc["cost"] = self.cost
        if self.profile is not None:
            doc["profile"] = self.profile
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "KeyStats":
        ks = cls(str(doc["key"]), str(doc.get("kind", "?")))
        ks.flushes = int(doc.get("flushes", 0))
        ks.compiles = int(doc.get("compiles", 0))
        ks.rows_in = int(doc.get("rows_in", 0))
        ks.rows_out = int(doc.get("rows_out", 0))
        ks.sel_observations = int(doc.get("sel_observations", 0))
        ks.wall_ms = Digest.from_doc(doc.get("wall_ms") or {})
        ks.compile_ms = Digest.from_doc(doc.get("compile_ms") or {})
        ks.host_syncs = int(doc.get("host_syncs", 0))
        ks.est_bytes_max = int(doc.get("est_bytes_max", 0))
        ks.peak_bytes_max = int(doc.get("peak_bytes_max", 0))
        cost = doc.get("cost")
        ks.cost = dict(cost) if isinstance(cost, dict) else None
        profile = doc.get("profile")
        ks.profile = dict(profile) if isinstance(profile, dict) else None
        ks.updated_at = float(doc.get("updated_at", 0.0))
        return ks


class StatStore:
    """The per-key running-statistics registry. Every mutation is
    lock-protected and lock-scoped (no device work, no I/O under the
    lock), so 16 serving workers hammering ``record_flush`` while a
    scraper reads ``report()`` lose no updates (test-pinned)."""

    def __init__(self):
        self._entries: dict[str, KeyStats] = {}
        self._lock = threading.Lock()
        # Serializes save(): the read-merge-write-replace cycle must be
        # one unit per process, or two threads sharing a tmp path could
        # tear the promoted snapshot (the exact failure the atomic
        # rename exists to prevent).
        self._persist_lock = threading.Lock()
        # (key, rows_in, device-scalar) observations awaiting ONE batched
        # host pull — drained on the cold paths only (see _drain).
        self._pending: list = []

    # -- recording (hot path: called only when spark.stats.enabled) -------
    def _entry_locked(self, key: str, kind: str) -> KeyStats:
        ks = self._entries.get(key)
        if ks is None:
            while len(self._entries) >= max(int(config.stats_max_entries), 1):
                # evict the least-recently-updated entry — history is an
                # optimization; a bounded table is the contract
                victim = min(self._entries.values(),
                             key=lambda e: e.updated_at)
                del self._entries[victim.key]
                profiling.counters.increment("stats.evict")
            ks = self._entries[key] = KeyStats(key, kind)
        return ks

    def record_flush(self, key: str, kind: str,
                     wall_ms: Optional[float] = None,
                     compiled: bool = False,
                     host_syncs: int = 0,
                     est_bytes: Optional[int] = None,
                     peak_bytes: Optional[int] = None) -> None:
        """One program execution at ``key`` (pipeline flush / grouped
        flush / any future producer). ``compiled`` routes the timing into
        the compile digest (it includes trace+compile), replays into the
        wall digest."""
        now = time.time()
        with self._lock:
            ks = self._entry_locked(key, kind)
            ks.flushes += 1
            if compiled:
                ks.compiles += 1
                if wall_ms is not None:
                    ks.compile_ms.observe(wall_ms)
            elif wall_ms is not None:
                ks.wall_ms.observe(wall_ms)
            ks.host_syncs += int(host_syncs)
            if est_bytes is not None and est_bytes > ks.est_bytes_max:
                ks.est_bytes_max = int(est_bytes)
            if peak_bytes is not None and peak_bytes > ks.peak_bytes_max:
                ks.peak_bytes_max = int(peak_bytes)
            ks.updated_at = now
        profiling.counters.increment("stats.record")

    def record_rows(self, key: str, kind: str, rows_in: int,
                    rows_out: int) -> None:
        """One observed (input slots → valid output rows) pair — the
        selectivity evidence. Host-known counts only; the deferred path
        is :meth:`defer_rows`."""
        with self._lock:
            ks = self._entry_locked(key, kind)
            ks.rows_in += max(int(rows_in), 0)
            ks.rows_out += max(int(rows_out), 0)
            ks.sel_observations += 1
            ks.updated_at = time.time()

    def defer_rows(self, key: str, kind: str, rows_in: int,
                   out_scalar) -> None:
        """Queue a DEVICE scalar (the flush's ``sum(mask)`` — already
        dispatched, never synced here) for a later batched pull. The hot
        path pays one tiny async reduction and a list append; the host
        read happens in :meth:`_drain` on report/EXPLAIN/save."""
        with self._lock:
            self._pending.append((key, kind, int(rows_in), out_scalar))
            if len(self._pending) > MAX_PENDING:
                self._pending.pop(0)
                dropped = True
            else:
                dropped = False
        if dropped:
            profiling.counters.increment("stats.pending_dropped")

    def drain_pending(self) -> None:
        """Pull every queued deferred observation in ONE batched
        read (cold paths only — report/EXPLAIN/save/stop; the
        pull is counted ``stats.drain_sync``, never a silent sync)."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        try:
            values = _pull_scalars([p[3] for p in pending])
            profiling.counters.increment("stats.drain_sync")
        except Exception:
            # a dead backend must not take a stats report down; the
            # observations are lost, the store stays coherent
            logger.debug("deferred selectivity drain failed", exc_info=True)
            return
        for (key, kind, rows_in, _), v in zip(pending, values):
            try:
                # a deferred observation may be a scalar OR a per-shard
                # count vector (the sharded flush's (devices,) output) —
                # the sum is the valid-row total either way
                self.record_rows(key, kind, rows_in, int(v))
            except Exception:
                logger.debug("deferred observation discarded", exc_info=True)

    # -- queries -----------------------------------------------------------
    def selectivity(self, key: str) -> Optional[float]:
        with self._lock:
            ks = self._entries.get(key)
            return ks.selectivity if ks is not None else None

    def est_rows(self, key: str, rows_in: int) -> Optional[int]:
        """History-informed output-row estimate for ``rows_in`` input
        slots (None without selectivity evidence) — the EXPLAIN
        ``est rows`` column."""
        sel = self.selectivity(key)
        if sel is None:
            return None
        return int(round(sel * max(int(rows_in), 0)))

    # -- cost model (the optimizer's read surface) -------------------------
    def compile_ms_p50(self, key: str) -> Optional[float]:
        """Median recorded trace+compile cost at ``key`` — the fused-
        stage boundary-placement input of the optimizer (still to
        port)."""
        with self._lock:
            ks = self._entries.get(key)
            return ks.compile_ms.p50() if ks is not None else None

    def wall_ms_p50(self, key: str) -> Optional[float]:
        """Median recorded replay-dispatch cost at ``key``."""
        with self._lock:
            ks = self._entries.get(key)
            return ks.wall_ms.p50() if ks is not None else None

    def bytes_bound(self, key: str) -> Optional[int]:
        """Remembered resident-byte bound at ``key``: the max of the
        static flush estimate, the MEASURED peak, and — when an AOT cost
        profile landed (``record_cost``), its recorded peak, across
        sessions: the memory-aware chunking input of the optimizer (still
        to port)."""
        with self._lock:
            ks = self._entries.get(key)
            if ks is None:
                return None
            cost_peak = int((ks.cost or {}).get("peak_bytes") or 0)
            bound = max(ks.est_bytes_max, ks.peak_bytes_max, cost_peak)
            return bound or None

    def record_cost(self, key: str, kind: str, cost: dict) -> None:
        """Attach an AOT cost profile (``utils/costprof.py``) to the
        entry at ``key`` — structural, so later sessions loading the
        snapshot skip the lower+compile extraction entirely."""
        with self._lock:
            ks = self._entry_locked(key, kind)
            ks.cost = dict(cost)
            ks.updated_at = time.time()

    def cost(self, key: str) -> Optional[dict]:
        with self._lock:
            ks = self._entries.get(key)
            return dict(ks.cost) if ks is not None and ks.cost else None

    def record_profile(self, key: str, kind: str, profile: dict) -> None:
        """Attach a DQ column-profile snapshot (``utils/dqprof.py``) to
        the entry at ``key`` (``dqprof|<column>``) — the persisted drift
        baseline later sessions adopt instead of re-learning one."""
        with self._lock:
            ks = self._entry_locked(key, kind)
            ks.profile = dict(profile)
            ks.updated_at = time.time()

    def profile(self, key: str) -> Optional[dict]:
        with self._lock:
            ks = self._entries.get(key)
            return dict(ks.profile) \
                if ks is not None and ks.profile else None

    def flops_for_selectivity(self, sel_key: Optional[str]
                              ) -> Optional[float]:
        """Largest recorded AOT-profile flop count over the entries whose
        plan key reduces (:func:`selectivity_key`) to ``sel_key`` — the
        join-reorder flop-cost term. Cost profiles land on FULL plan keys
        (``record_cost``) while selectivity evidence lands on the reduced
        key, so this is the bridge between the two; a linear scan over a
        bounded table (``spark.stats.maxEntries``), paid once per plan.
        None until an extraction lands, so rows-only ranking stays in
        charge on cold history."""
        if sel_key is None:
            return None
        best = None
        with self._lock:
            for ks in self._entries.values():
                if not ks.cost:
                    continue
                if selectivity_key(ks.key) != sel_key:
                    continue
                flops = float(ks.cost.get("flops") or 0.0)
                if flops > 0.0 and (best is None or flops > best):
                    best = flops
        return best

    def record_miss(self, key: str) -> None:
        """One planning miss at ``key`` (e.g. the grouped engine's dense
        slot-table overflow): accumulates as a ``miss|``-prefixed entry
        whose flush count is the evidence :meth:`miss_count` reads —
        persisted like any entry, so the skip decision survives
        sessions."""
        self.record_flush(f"miss|{key}", "miss")

    def miss_count(self, key: str) -> int:
        with self._lock:
            ks = self._entries.get(f"miss|{key}")
            return ks.flushes if ks is not None else 0

    def entry(self, key: str) -> Optional[dict]:
        with self._lock:
            ks = self._entries.get(key)
            return ks.to_doc() if ks is not None else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def report(self, drain: bool = True) -> dict:
        """The programmatic view (``session.stats_report()`` / the HTTP
        ``/plans`` route): one summary row per key, selectivity and
        digest summaries precomputed."""
        if drain:
            self.drain_pending()
        with self._lock:
            entries = [ks for ks in self._entries.values()]
            rows = []
            for ks in sorted(entries, key=lambda e: -e.observations()):
                rows.append({
                    "key": ks.key[:160], "kind": ks.kind,
                    "flushes": ks.flushes, "compiles": ks.compiles,
                    "selectivity": (None if ks.selectivity is None
                                    else round(ks.selectivity, 6)),
                    "rows_in": ks.rows_in, "rows_out": ks.rows_out,
                    "sel_observations": ks.sel_observations,
                    "wall_ms_mean": ks.wall_ms.mean(),
                    "wall_ms_p50": ks.wall_ms.p50(),
                    "wall_ms_p90": ks.wall_ms.p90(),
                    "wall_ms_p99": ks.wall_ms.quantile(0.99),
                    "compile_ms_mean": ks.compile_ms.mean(),
                    "compile_ms_p50": ks.compile_ms.p50(),
                    "host_syncs": ks.host_syncs,
                    "est_bytes_max": ks.est_bytes_max,
                    "peak_bytes_max": ks.peak_bytes_max,
                    "cost": ks.cost,
                })
        return {"entries": rows, "size": len(rows),
                "version": SCHEMA_VERSION}

    def absorb_query_stats(self, qs) -> None:
        """Fold one finished ``observability.query_stats`` collection
        into the store: per-span-CATEGORY wall digests (``span:frame``,
        ``span:fit``, …) plus measured peak bytes — the coarse per-query
        memory EXPLAIN ANALYZE already gathered, remembered instead of
        discarded."""
        now = time.time()
        with self._lock:
            for s in getattr(qs, "spans", ()):
                cat = getattr(s, "cat", "") or "other"
                ks = self._entry_locked(f"span:{cat}", "span")
                ks.flushes += 1
                ks.wall_ms.observe((getattr(s, "dur_us", 0) or 0) / 1e3)
                peak = (getattr(s, "attrs", None) or {}).get("peak_mem")
                if peak and peak > ks.peak_bytes_max:
                    ks.peak_bytes_max = int(peak)
                ks.updated_at = now

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._pending = []

    # -- persistence -------------------------------------------------------
    def _snapshot_entries(self) -> list:
        with self._lock:
            return [KeyStats.from_doc(ks.to_doc())
                    for ks in self._entries.values()]

    @staticmethod
    def _merge_into(target: dict, entries) -> None:
        """Merge-don't-clobber: per key, the variant with MORE evidence
        wins whole (count-summing would double-count the shared history
        a load/save cycle copies back and forth — winner-take-key is
        idempotent under any repeat of load/merge/save)."""
        for ks in entries:
            cur = target.get(ks.key)
            if cur is None or ks.observations() > cur.observations() or (
                    ks.observations() == cur.observations()
                    and ks.updated_at > cur.updated_at):
                if cur is not None and ks.cost is None:
                    # the cost profile is structural per key — a winner
                    # that never extracted one must not drop the
                    # loser's (re-extraction costs a compile)
                    ks.cost = cur.cost
                if cur is not None and ks.profile is None:
                    # same for the DQ profile snapshot: dropping it
                    # would silently reset the drift baseline
                    ks.profile = cur.profile
                target[ks.key] = ks
            else:
                if cur.cost is None and ks.cost is not None:
                    cur.cost = ks.cost
                if cur.profile is None and ks.profile is not None:
                    cur.profile = ks.profile

    @staticmethod
    def _trim(target: dict, bound: int) -> int:
        """Evict least-recently-updated entries past ``bound`` (the
        ``spark.stats.maxEntries`` contract — enforced on the merge
        paths too, so a huge snapshot can neither blow the in-memory
        table nor grow the on-disk file monotonically across
        sessions). Returns the eviction count."""
        bound = max(int(bound), 1)
        excess = len(target) - bound
        if excess <= 0:
            return 0
        for ks in sorted(target.values(),
                         key=lambda e: e.updated_at)[:excess]:
            del target[ks.key]
        return excess

    def load(self, path: str) -> int:
        """Merge a persisted snapshot into the live store; returns the
        number of entries adopted. A missing file is a clean 0; a
        corrupt, torn, or version-skewed file degrades to EMPTY with a
        recovery event (``stats_persist``/``fallback`` rung ``empty``)
        and a ``stats.load_failed`` counter — persisted history is an
        optimization, never a crash."""
        from . import faults as _faults
        from .recovery import RECOVERY_LOG

        try:
            _faults.inject("stats_persist")
            with open(path) as f:
                header = json.loads(f.readline() or "null")
                if not isinstance(header, dict) \
                        or header.get("version") != SCHEMA_VERSION:
                    ver = (header.get("version")
                           if isinstance(header, dict) else header)
                    raise ValueError(
                        f"snapshot version {ver!r} != {SCHEMA_VERSION}")
                loaded = [KeyStats.from_doc(json.loads(line))
                          for line in f if line.strip()]
        except FileNotFoundError:
            return 0
        except Exception as e:
            profiling.counters.increment("stats.load_failed")
            RECOVERY_LOG.record(
                "stats_persist", "fallback", rung="empty",
                cause=f"{type(e).__name__}: {e}",
                detail=f"corrupt/stale stats snapshot {path!r}; "
                       "starting with empty history")
            logger.warning("stats snapshot %s unreadable (%s); starting "
                           "with empty history", path, e)
            return 0
        with self._lock:
            self._merge_into(self._entries, loaded)
            evicted = self._trim(self._entries, config.stats_max_entries)
        if evicted:
            profiling.counters.increment("stats.evict", evicted)
        if loaded:
            profiling.counters.increment("stats.loaded", len(loaded))
        return len(loaded)

    def save(self, path: str, merge: bool = True) -> bool:
        """Persist the store atomically; returns False (in-memory-only
        degrade, with a recovery event + ``stats.persist_failed``) on any
        I/O failure — including the injected ``stats_persist`` faults.
        ``merge=True`` folds the CURRENT file contents in first so a
        concurrent/previous writer is merged, not clobbered (the merged
        set is trimmed to ``spark.stats.maxEntries`` so the file cannot grow
        monotonically across sessions). The temp file is promoted by
        ``os.replace`` only after a full write+flush: a torn write never
        replaces the previous snapshot. In-process saves serialize on
        ``_persist_lock`` (and the temp name carries the thread id):
        without both, two racing saves could share the temp path and
        one's late writes would land inside the already-promoted live
        snapshot — exactly the torn file this method promises away."""
        from . import faults as _faults
        from .recovery import RECOVERY_LOG

        self.drain_pending()
        entries = {ks.key: ks for ks in self._snapshot_entries()}
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with self._persist_lock:
                _faults.inject("stats_persist")
                if merge and os.path.exists(path):
                    disk: dict[str, KeyStats] = {}
                    try:
                        with open(path) as f:
                            header = json.loads(f.readline() or "null")
                            if isinstance(header, dict) \
                                    and header.get("version") \
                                    == SCHEMA_VERSION:
                                self._merge_into(
                                    disk,
                                    [KeyStats.from_doc(json.loads(line))
                                     for line in f if line.strip()])
                    except Exception:
                        disk = {}   # a corrupt file cannot poison the write
                    self._merge_into(disk, entries.values())
                    entries = disk
                self._trim(entries, config.stats_max_entries)
                lines = [json.dumps({"version": SCHEMA_VERSION,
                                     "saved_at": time.time(),
                                     "entries": len(entries)})]
                lines.extend(json.dumps(ks.to_doc(), sort_keys=True)
                             for ks in entries.values())
                payload = "\n".join(lines) + "\n"
                torn = _faults.fired("stats_persist", "torn_chunk")
                with open(tmp, "w") as f:
                    if torn:
                        # the torn-write fault: half the payload lands,
                        # then the write dies; the snapshot stays whole
                        f.write(payload[: max(len(payload) // 2, 1)])
                        f.flush()
                        raise _faults.InjectedIOError(
                            "injected torn write at 'stats_persist'")
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
        except Exception as e:
            profiling.counters.increment("stats.persist_failed")
            RECOVERY_LOG.record(
                "stats_persist", "fallback", rung="memory",
                cause=f"{type(e).__name__}: {e}",
                detail=f"stats snapshot {path!r} not written; "
                       "continuing in-memory only")
            logger.warning("stats snapshot %s not written (%s); "
                           "continuing in-memory only", path, e)
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        profiling.counters.increment("stats.persisted")
        return True


#: Process-global statistics store. ``spark.stats.enabled`` (the
#: ``config.stats_enabled`` flag) gates every producer hook; the store
#: object itself always exists so readers never race a None.
STORE = StatStore()


def enabled() -> bool:
    from ..config import config

    return bool(config.stats_enabled)


def selectivity_key(plan_key: str) -> Optional[str]:
    """The FILTER-structural identity of a pipeline plan key: the engine
    dtype tag plus every ``F:`` component, namespace tag stripped. Two
    flushes whose filter stacks are structurally identical (literals
    hoisted, projections ignored) share one selectivity entry — and the
    SAME extraction applied to a key built from a parsed query's WHERE at
    EXPLAIN time (zero execution) addresses the SAME entry, which is what
    makes history-informed ``est rows`` possible on a fresh session."""
    parts = plan_key.split("|")
    if parts and parts[0].startswith("ns:"):
        parts = parts[1:]
    if parts and parts[0].startswith("shard["):
        # layout tags stay out of the selectivity identity: a filter's
        # observed selectivity is a data property, so sharded and
        # single-device flushes of the same WHERE share one entry (and
        # EXPLAIN's layout-agnostic probe keeps addressing it)
        parts = parts[1:]
    if not parts:
        return None
    fparts = [p for p in parts[1:] if p.startswith("F:")]
    if not fparts:
        return None
    return parts[0] + "|" + "|".join(fparts)
