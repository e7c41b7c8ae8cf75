"""Grouped execution on the frame's device: ``group_by().agg()``, ``sort``
and ``distinct`` (single-device subset of ``sparkdq4ml_tpu/ops/segments.py``).

The JAX package lowers each plan to one jitted XLA program; here the same
programs run as eager torch ops on the frame's device (``torch.sort(stable=
True)``, ``cumsum``, ``searchsorted``, ``index_add_``, ``scatter_reduce_``,
``index_select``), so a CUDA frame runs on the card and a CPU frame on the
CPU. Float segment sums go through the port's own kernels
(``kernels.dense_segment_sum``, ``kernels.sorted_segment_sum``), which add
in an order fixed by the plan, so a result is bit-identical from run to
run on the card; integer sums stay on ``index_add_`` (exact in any order).
Two lowerings of ``grouped_agg`` share one output contract:

* the **dense** program (integer-valued keys whose packed range fits
  ``S = min(2^17, max(2 n, 16))`` slots): each row's key tuple maps to a
  lexicographic slot id with no row sort, every aggregate reduces into
  stacked slot tables, and the present slots compact by a ``searchsorted``
  over their prefix sum;
* the **sorted** program (other keys, and the distinct aggregates): a
  stable lexicographic sort over (invalid flag, per key: not-null flag,
  value), segment ids from the boundaries, reductions per segment.

String keys run as int32 codes (``ops/strings.py``): the host encodes
them in the strings' order, ``NULL_CODE`` first, and decodes the result's
keys.

Host reads: two per dense ``grouped_agg`` (the fit verdict with the table
size, then the group count), one on a dense miss and one per sorted
program (the group count); one per ``device_sort`` (the valid-row count)
and per ``device_unique`` (the group count); string keys add their
dictionary pass.

Semantics are the JAX package's: masked rows carry no weight; NaN keys form
one null group that sorts first; aggregates skip NaN values, with the
empty -> NULL and n < 2 -> NULL variance rules; row order and output
dtypes match, and ``-0.0`` groups with ``0.0``.
Ineligible input (a 2-D key for grouping, an aggregated string column,
an aggregate outside ``DEVICE_AGG_FNS``) raises ``NotImplementedError``:
there is no host path to fall back to. An empty frame (no row slots), and
a grouping on string keys with no valid row, are answered directly with
the JAX package's empty-result dtypes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import float_dtype, int_dtype, wide_types
from . import kernels, strings
from .expressions import is_host_column

__all__ = ["DEVICE_AGG_FNS", "grouped_agg", "device_sort", "device_unique",
           "gather_rows"]

# Aggregates this engine computes (the names of frame.aggregates, after
# the mean -> avg normalisation).
DEVICE_AGG_FNS = frozenset({
    "count", "sum", "avg", "min", "max", "stddev", "variance",
    "stddev_pop", "var_pop", "first", "last", "count_distinct",
    "sum_distinct",
})

_DISTINCT_FNS = frozenset({"count_distinct", "sum_distinct"})
_VAR_FNS = ("stddev", "variance", "stddev_pop", "var_pop")

# Dense-table ceiling: the packed key range must fit min(this, 2 n) slots
# or the plan reroutes to the sorted program.
_DENSE_MAX = 1 << 17


# ---------------------------------------------------------------------------
# Column classification
# ---------------------------------------------------------------------------

def _key_kind(arr) -> Optional[str]:
    """Component kind of a 1-D device column: ``f`` float (NaN = NULL),
    ``b`` bool, ``i`` other integer; None = ineligible."""
    if arr is None or is_host_column(arr) or not isinstance(
            arr, torch.Tensor) or arr.ndim != 1:
        return None
    if arr.is_floating_point():
        return "f"
    if arr.dtype == torch.bool:
        return "b"
    return "i"


def _acc_dtype() -> torch.dtype:
    """Float accumulator: float64 under the float64 policy (the JAX
    package's x64 mode), else float32, as on the TPU."""
    return torch.float64 if wide_types() else torch.float32


def _wide_int() -> torch.dtype:
    """Integer accumulator: int64 under the float64 policy, else int32
    (the JAX package's canonical int64 without x64)."""
    return torch.int64 if wide_types() else torch.int32


def _require_kind(arr, name: str, what: str) -> str:
    kind = _key_kind(arr)
    if kind is None:
        shape = ("a string column" if is_host_column(arr)
                 else f"a {tuple(arr.shape)} column")
        raise NotImplementedError(
            f"{what} {name!r} is {shape}; the torch port groups, sorts and "
            "aggregates 1-D numeric and boolean columns, and groups, sorts "
            "and joins on string keys")
    return kind


def _key_columns(frame, names, what: str):
    """``(arrays, kinds, words)`` of the key columns ``names``: a string
    column becomes its int32 codes on the frame's device (kind ``i``,
    nulls first) with its dictionary in ``words``; another column must be
    a 1-D numeric or boolean one."""
    arrs, kinds, words = [], [], {}
    for k in names:
        arr = frame._column_values(k)
        if is_host_column(arr):
            (arr,), words[len(arrs)] = strings.device_codes([arr],
                                                            frame.device)
        kinds.append(_require_kind(arr, k, what))
        arrs.append(arr)
    return arrs, kinds, words


def _key_components(arr, kind: str):
    """Sort components of one group key, highest priority first: a
    not-null flag (False first, so NULL leads) and the value with NaN
    neutralised, so the flag alone places the nulls. ``-0.0`` and ``0.0``
    compare equal and keep row order, as under ``lax.sort``."""
    if kind == "b":
        return [arr.to(torch.int8)]
    if kind == "f":
        null = torch.isnan(arr)
        return [(~null).to(torch.uint8),
                torch.where(null, torch.zeros_like(arr), arr)]
    return [arr]


def _lex_perm(sort_keys, n: int, device, descending=None) -> torch.Tensor:
    """Stable lexicographic permutation over ``sort_keys`` (highest
    priority first; ``descending[i]`` flips key i): one stable sort pass
    per key, least significant first, so ties keep row order like
    ``np.lexsort``."""
    perm = torch.arange(n, device=device)
    for i in reversed(range(len(sort_keys))):
        _, order = torch.sort(sort_keys[i].index_select(0, perm),
                              stable=True,
                              descending=bool(descending and descending[i]))
        perm = perm.index_select(0, order)
    return perm


def _group_scaffold(keys, kinds, mask):
    """Sorted group discovery: ``(perm, valid, seg, boundary)`` with the
    invalid rows last and ``seg`` the sorted rows' group ids (clamped at
    0, so an all-invalid frame reduces nothing)."""
    n = mask.shape[0]
    comps = [c for k, kind in zip(keys, kinds)
             for c in _key_components(k, kind)]
    perm = _lex_perm([(~mask).to(torch.uint8)] + comps, n, mask.device)
    valid = mask.index_select(0, perm)
    boundary = valid.clone()
    if n > 1:
        neq = torch.zeros(n - 1, dtype=torch.bool, device=mask.device)
        for c in comps:
            cs = c.index_select(0, perm)
            neq |= cs[1:] != cs[:-1]
        boundary[1:] &= neq
    seg = (torch.cumsum(boundary.to(torch.int64), 0) - 1).clamp_(min=0)
    return perm, valid, seg, boundary


# ---------------------------------------------------------------------------
# Segment reductions (the torch counterparts of jax.ops.segment_*)
# ---------------------------------------------------------------------------

def _seg_sum(x, seg, size: int, contiguous: bool = False):
    """``out[s] = Σ x[seg == s]`` over ids in ``[0, size)``. Integer sums
    run on ``index_add_`` (exact in any order); float sums in a fixed
    order through the segment-sum kernels: the sorted kernel for the
    nondecreasing ids of the sorted program (``contiguous``), the dense
    kernel for a table that fits its shared memory, else the sorted
    kernel after a stable sort of the ids."""
    if not x.is_floating_point():
        out = torch.zeros((size,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return out.index_add_(0, seg, x)
    if contiguous:
        return kernels.sorted_segment_sum(x, seg, size)
    cols = x.shape[1] if x.ndim == 2 else 1
    if kernels.dense_segment_fits(size, cols, x.element_size()):
        return kernels.dense_segment_sum(x, seg, size)
    order = torch.sort(seg, stable=True).indices
    return kernels.sorted_segment_sum(x.index_select(0, order),
                                      seg.index_select(0, order), size)


def _seg_extreme(x, seg, size: int, fill, reduce: str):
    out = torch.full((size,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    idx = seg if x.ndim == 1 else seg[:, None].expand(-1, x.shape[1])
    return out.scatter_reduce_(0, idx, x, reduce=reduce, include_self=True)


def _nan(dtype, device):
    return torch.full((), float("nan"), dtype=dtype, device=device)


def _to_int8_if_bool(v):
    return v.to(torch.int8) if v.dtype == torch.bool else v


# ---------------------------------------------------------------------------
# Dense lowering: integer-valued keys packed into one lexicographic slot id
# ---------------------------------------------------------------------------

def _dense_slots(keys, kinds, valid, S: int):
    """Per-row slot ids, the fit verdict (a device bool), the table size
    (the product of the digit ranges, in the float accumulator) and the
    key decoders. Each key contributes a digit 0 for NULL else ``k - lo + 1``,
    so ascending slot order is the lexicographic group order with nulls
    first. The digits are built in the float accumulator and cast to
    int32 only after the verdict has zeroed them on a miss: a key range
    past the accumulator's exact-integer window (2^53, or 2^24 in float32)
    or the table size reroutes, never aliases two groups."""
    acc = _acc_dtype()
    dev = valid.device
    big = torch.tensor(float("inf"), dtype=acc, device=dev)
    exact = 2.0 ** (53 if acc == torch.float64 else 24)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    sizes, infos, floats = [], [], []
    for k, kind in zip(keys, kinds):
        af = _to_int8_if_bool(k).to(acc)
        floats.append(af)
        if kind == "f":
            nonnull = valid & ~torch.isnan(af)
            ok = ok & torch.where(nonnull, af == torch.round(af),
                                  True).all()
        else:
            nonnull = valid
        any_nn = nonnull.any()
        lo = torch.where(nonnull, af, big).min()
        hi = torch.where(nonnull, af, -big).max()
        lo = torch.where(any_nn, lo, torch.zeros_like(lo))
        hi = torch.where(any_nn, hi, torch.full_like(hi, -1.0))
        sizes.append(hi - lo + 2)               # +1 digit offset, +1 null
        infos.append((kind, lo, k.dtype))
        ok = ok & (lo.abs() < exact) & (hi.abs() < exact)
    total = sizes[0]
    for s in sizes[1:]:
        total = total * s
    ok = ok & torch.isfinite(total) & (total <= S)

    strides = [None] * len(keys)                # last key = fastest digit
    stride = torch.ones((), dtype=acc, device=dev)
    for i in range(len(keys) - 1, -1, -1):
        strides[i] = stride
        stride = stride * sizes[i]
    safe = ok.to(acc)
    slot = torch.zeros(valid.shape, dtype=torch.int32, device=dev)
    for (kind, lo, _dt), st, af in zip(infos, strides, floats):
        digit = af - lo + 1
        if kind == "f":
            digit = torch.where(torch.isnan(af), torch.zeros_like(af), digit)
        contrib = torch.nan_to_num(digit * st * safe, nan=0.0, posinf=0.0,
                                   neginf=0.0)
        slot = slot + contrib.to(torch.int32)

    def make_decoder(kind, lo, dt, st, size):
        def decode(t_idx):
            tf = t_idx.to(acc)
            digit = torch.floor(tf / st) % size
            val = lo + digit - 1
            if kind == "f":
                return torch.where(digit == 0, _nan(acc, dev), val).to(dt)
            if kind == "b":
                return val.to(torch.int8).to(dt)
            return val.to(dt)
        return decode

    decoders = [make_decoder(kind, lo, dt, st, size)
                for (kind, lo, dt), st, size in zip(infos, strides, sizes)]
    return slot, ok, total, decoders


def _dense_agg(keys, kinds, vals, val_kinds, agg_ops, mask, S: int):
    """The dense program. Returns ``(key_outs, agg_outs)`` or None when
    the key range does not fit (the caller reroutes)."""
    acc, wide = _acc_dtype(), _wide_int()
    n = mask.shape[0]
    dev = mask.device
    valid = mask
    idx = torch.arange(n, device=dev)
    slot, ok, total, decoders = _dense_slots(keys, kinds, valid, S)
    # host read 1: the fit verdict and the table size T (slot T collects
    # the masked rows), so the tables hold T + 1 slots, not S + 1
    ok_h, T = torch.stack([ok.to(acc), torch.where(
        ok, total, torch.zeros_like(total))]).tolist()
    if not ok_h:
        return None
    T = int(T)
    seg = torch.where(valid, slot, torch.full_like(slot, T)).to(torch.int64)

    nonnull = [valid & ~torch.isnan(v) if vk == "f" else valid
               for v, vk in zip(vals, val_kinds)]

    def vwide(i):
        return _to_int8_if_bool(vals[i]).to(wide)

    def wfill(v):
        return torch.full((), v, dtype=wide, device=dev)

    # Stacked reductions: every sum-like member in one (n, C) index_add_
    # per domain, min/max members in one scatter_reduce_ each. Counts and
    # row indices are bounded by n, so they ride the float stacks whenever
    # n is inside the accumulator's exact-integer window.
    stacks = {"ai": [], "af": [], "mf": [], "mi": [], "xi": []}
    index: dict = {}

    def want(stack, name, arr):
        if name not in index:
            index[name] = (stack, len(stacks[stack]))
            stacks[stack].append(arr)

    small_n = n < (1 << (53 if acc == torch.float64 else 24))
    cstk, cdt = ("af", acc) if small_n else ("ai", wide)
    big_f = torch.tensor(float("inf"), dtype=acc, device=dev)
    big_i = torch.iinfo(wide).max
    small_i = torch.iinfo(wide).min
    want(cstk, "present", valid.to(cdt))
    for fn, s_i, ig in agg_ops:
        if s_i < 0:
            continue
        nn = nonnull[s_i]
        want(cstk, f"cnt{s_i}", nn.to(cdt))
        if fn in ("sum", "avg") + _VAR_FNS:
            if val_kinds[s_i] != "f":
                want("ai", f"sum{s_i}",
                     torch.where(valid, vwide(s_i), wfill(0)))
            else:
                vf = vals[s_i].to(acc)
                want("af", f"sum{s_i}",
                     torch.where(nn, vf, torch.zeros_like(vf)))
        elif fn in ("min", "max"):
            if val_kinds[s_i] == "f":
                vf = vals[s_i].to(acc)
                want("mf", f"{fn}{s_i}",
                     torch.where(nn, vf if fn == "min" else -vf, big_f))
            elif fn == "min":
                want("mi", f"min{s_i}",
                     torch.where(valid, vwide(s_i), wfill(big_i)))
            else:
                want("xi", f"max{s_i}",
                     torch.where(valid, vwide(s_i), wfill(small_i)))
        elif fn in ("first", "last"):
            gate = nn if ig else valid
            tag = "fst" if fn == "first" else "lst"
            if small_n:
                # last rides the min stack negated (indices are exact)
                pos = idx.to(acc) if fn == "first" else -idx.to(acc)
                want("mf", f"{tag}{s_i}{ig}", torch.where(gate, pos, big_f))
            elif fn == "first":
                want("mi", f"fst{s_i}{ig}",
                     torch.where(gate, idx.to(wide), wfill(big_i)))
            else:
                want("xi", f"lst{s_i}{ig}",
                     torch.where(gate, idx.to(wide), wfill(-1)))

    reduced = {}
    for stack, arrs in stacks.items():
        if not arrs:
            continue
        x = torch.stack(arrs, dim=1)
        if stack in ("ai", "af"):
            r = _seg_sum(x, seg, T + 1)
        elif stack in ("mf", "mi"):
            fill = float("inf") if stack == "mf" else big_i
            r = _seg_extreme(x, seg, T + 1, fill, "amin")
        else:
            r = _seg_extreme(x, seg, T + 1, small_i, "amax")
        reduced[stack] = r[:T]

    def table(name):
        stack, j = index[name]
        return reduced[stack][:, j]

    present = table("present") > 0
    g = int(present.sum())                      # host read 2: the groups

    cs = torch.cumsum(present.to(torch.int32), 0)
    comp = torch.searchsorted(
        cs, torch.arange(1, g + 1, dtype=torch.int32, device=dev))

    def at(name):
        return table(name).index_select(0, comp)

    def fsum(s_i):
        s = table(f"sum{s_i}")
        return s if val_kinds[s_i] == "f" else s.to(acc)

    # variance family second pass: the two-pass sum of (v - mean)^2
    need_var = list(dict.fromkeys(s_i for fn, s_i, _ in agg_ops
                                  if fn in _VAR_FNS))
    ssd = {}
    if need_var:
        seg_c = seg.clamp(max=T - 1)
        cols = []
        for s_i in need_var:
            vf = vals[s_i].to(acc)
            mu = fsum(s_i) / table(f"cnt{s_i}").to(acc)
            d = torch.where(nonnull[s_i], vf - mu.index_select(0, seg_c),
                            torch.zeros_like(vf))
            cols.append(d * d)
        tab = _seg_sum(torch.stack(cols, dim=1), seg, T + 1)[:T]
        for j, s_i in enumerate(need_var):
            ssd[s_i] = tab[:, j].index_select(0, comp)

    nan = _nan(acc, dev)
    key_outs = [dec(comp) for dec in decoders]
    agg_outs = []
    for fn, s_i, ig in agg_ops:
        if fn == "count" and s_i < 0:
            agg_outs.append(at("present").to(int_dtype()))
            continue
        vs = vals[s_i]
        cnt = at(f"cnt{s_i}")
        if fn == "count":
            agg_outs.append(cnt.to(int_dtype()))
        elif fn == "sum":
            s = at(f"sum{s_i}")
            if val_kinds[s_i] != "f":
                agg_outs.append(s.to(int_dtype()))
            else:
                agg_outs.append(torch.where(cnt > 0, s, nan).to(vs.dtype))
        elif fn == "avg":
            agg_outs.append((fsum(s_i).index_select(0, comp)
                             / cnt.to(acc)).to(float_dtype()))
        elif fn in _VAR_FNS:
            cf = cnt.to(acc)
            if fn in ("stddev", "variance"):
                var = torch.where(cnt > 1, ssd[s_i] / torch.clamp(cf - 1,
                                                                  min=1), nan)
            else:
                var = torch.where(cnt > 0, ssd[s_i] / torch.clamp(cf, min=1),
                                  nan)
            out = var if fn in ("variance", "var_pop") else torch.sqrt(var)
            agg_outs.append(out.to(float_dtype()))
        elif fn in ("min", "max"):
            m = at(f"{fn}{s_i}")
            if val_kinds[s_i] == "f":
                if fn == "max":
                    m = -m
                agg_outs.append(torch.where(cnt > 0, m, nan).to(vs.dtype))
            else:
                agg_outs.append(m.to(vs.dtype))
        else:                                   # first / last
            tag = "fst" if fn == "first" else "lst"
            pos = at(f"{tag}{s_i}{ig}")
            if fn == "last" and index[f"{tag}{s_i}{ig}"][0] == "mf":
                pos = -pos
            pi = pos.clamp(0, n - 1).to(torch.int64)
            picked = vs.index_select(0, pi)
            if ig and val_kinds[s_i] == "f":
                picked = torch.where(cnt > 0, picked,
                                     _nan(vs.dtype, dev))
            agg_outs.append(picked)
    return key_outs, agg_outs


# ---------------------------------------------------------------------------
# Sorted lowering (arbitrary keys; the distinct aggregates)
# ---------------------------------------------------------------------------

def _distinct_runs(seg, v, eligible, n: int):
    """Re-sort (segment, value) among eligible rows (ineligible rows get
    segment n and sort last), then flag the first row of every
    (segment, value) run. The sorted segments are nondecreasing."""
    seg_k = torch.where(eligible, seg, torch.full_like(seg, n))
    val_k = torch.where(eligible, v, torch.zeros_like(v))
    perm = _lex_perm([seg_k, val_k], n, seg.device)
    s2, v2 = seg_k.index_select(0, perm), val_k.index_select(0, perm)
    live = s2 < n
    first = live.clone()
    if n > 1:
        first[1:] &= (s2[1:] != s2[:-1]) | (v2[1:] != v2[:-1])
    return s2, v2, first


def _sorted_agg(keys, kinds, vals, val_kinds, agg_ops, mask):
    acc = _acc_dtype()
    n = mask.shape[0]
    dev = mask.device
    idx = torch.arange(n, device=dev)
    perm, valid, seg, boundary = _group_scaffold(keys, kinds, mask)
    g = int(boundary.sum())                     # THE host read
    G = max(g, 1)

    def seg_sum(x):
        return _seg_sum(x, seg, G, contiguous=True)

    first_pos = _seg_extreme(torch.where(valid, idx, n), seg, G, n, "amin")
    fp = first_pos.clamp(0, n - 1)
    orig_first = perm.index_select(0, fp)
    key_outs = [k.index_select(0, orig_first) for k in keys]
    last_pos = _seg_extreme(torch.where(valid, idx, -1), seg, G, -1, "amax")
    lp = last_pos.clamp(0, n - 1)

    sorted_vals = [v.index_select(0, perm) for v in vals]
    nonnull = [valid & ~torch.isnan(vs) if vk == "f" else valid
               for vs, vk in zip(sorted_vals, val_kinds)]
    nan = _nan(acc, dev)
    wide = _wide_int()

    agg_outs = []
    for fn, s_i, ig in agg_ops:
        if fn == "count" and s_i < 0:
            agg_outs.append(seg_sum(valid.to(torch.int32)).to(int_dtype()))
            continue
        nn = nonnull[s_i]
        vs = sorted_vals[s_i]
        if fn == "count":
            agg_outs.append(seg_sum(nn.to(torch.int32)).to(int_dtype()))
        elif fn in ("sum", "avg") + _VAR_FNS:
            vf = vs.to(acc)
            cnt = seg_sum(nn.to(acc))
            s = seg_sum(torch.where(nn, vf, torch.zeros_like(vf)))
            if fn == "sum":
                if val_kinds[s_i] != "f":
                    agg_outs.append(seg_sum(torch.where(
                        valid, _to_int8_if_bool(vs).to(wide),
                        torch.zeros((), dtype=wide, device=dev)))
                        .to(int_dtype()))
                else:
                    agg_outs.append(torch.where(cnt > 0, s, nan)
                                    .to(vs.dtype))
            elif fn == "avg":
                agg_outs.append((s / cnt).to(float_dtype()))
            else:
                mu = s / cnt
                d = torch.where(nn, vf - mu.index_select(0, seg),
                                torch.zeros_like(vf))
                ss = seg_sum(d * d)
                if fn in ("stddev", "variance"):
                    var = torch.where(cnt > 1,
                                      ss / torch.clamp(cnt - 1, min=1), nan)
                else:
                    var = torch.where(cnt > 0, ss / torch.clamp(cnt, min=1),
                                      nan)
                out = var if fn in ("variance", "var_pop") \
                    else torch.sqrt(var)
                agg_outs.append(out.to(float_dtype()))
        elif fn in ("min", "max"):
            red = "amin" if fn == "min" else "amax"
            if val_kinds[s_i] == "f":
                fill = float("inf") if fn == "min" else float("-inf")
                m = _seg_extreme(
                    torch.where(nn, vs, torch.full_like(vs, fill)), seg, G,
                    fill, red)
                cnt = seg_sum(nn.to(torch.int32))
                agg_outs.append(torch.where(cnt > 0, m,
                                            _nan(vs.dtype, dev)))
            else:
                vi = vs.to(torch.int32) if vs.dtype == torch.bool else vs
                info = torch.iinfo(vi.dtype)
                fill = info.max if fn == "min" else info.min
                m = _seg_extreme(torch.where(valid, vi,
                                             torch.full_like(vi, fill)),
                                 seg, G, fill, red)
                agg_outs.append(m.to(vs.dtype))
        elif fn in ("first", "last"):
            if ig:
                pos = (_seg_extreme(torch.where(nn, idx, n), seg, G, n,
                                    "amin") if fn == "first" else
                       _seg_extreme(torch.where(nn, idx, -1), seg, G, -1,
                                    "amax"))
                has = seg_sum(nn.to(torch.int32)) > 0
                picked = vs.index_select(0, pos.clamp(0, n - 1))
                if val_kinds[s_i] == "f":
                    picked = torch.where(has, picked, _nan(vs.dtype, dev))
                agg_outs.append(picked)
            else:
                agg_outs.append(vs.index_select(0, fp if fn == "first"
                                                else lp))
        else:                                   # count / sum DISTINCT
            vn = _to_int8_if_bool(vs)
            s2, v2, firstrun = _distinct_runs(seg, vn, nn, n)
            # the ineligible rows sort last: the last segment takes them
            # (their values are zero) and the ids stay nondecreasing
            sid = torch.where(s2 < n, s2, torch.full_like(s2, G - 1))
            if fn == "count_distinct":
                agg_outs.append(_seg_sum(firstrun.to(torch.int32), sid, G)
                                .to(int_dtype()))
            elif val_kinds[s_i] != "f":
                agg_outs.append(_seg_sum(torch.where(
                    firstrun, v2, torch.zeros_like(v2)).to(wide), sid, G)
                    .to(int_dtype()))
            else:
                sd = _seg_sum(torch.where(firstrun, v2.to(acc),
                                          torch.zeros((), dtype=acc,
                                                      device=dev)), sid, G,
                              contiguous=True)
                cd = _seg_sum(firstrun.to(torch.int32), sid, G)
                agg_outs.append(torch.where(cd > 0, sd, nan)
                                .to(float_dtype()))
    return ([k[:g] for k in key_outs], [a[:g] for a in agg_outs])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _empty_frame(names, device):
    """The JAX package's answer for a frame with no row slots: its host
    path builds every column from an empty list (the float dtype)."""
    from ..frame.frame import Frame

    return Frame({name: torch.empty(0, dtype=float_dtype(), device=device)
                  for name in names}, device=device)


def grouped_agg(frame, keys, agg_list):
    """``group_by(keys).agg(agg_list)`` on the frame's device. Rows come
    out in lexicographic key order with the null group first; the result
    is a compact frame. ``agg_list`` holds plain column aggregates
    (``frame.aggregates.AggExpr``)."""
    from ..frame.frame import Frame

    data = frame._data
    n = frame.num_slots
    names = list(keys) + [a.name for a in agg_list]
    key_arrs, key_kinds, words = _key_columns(frame, keys, "group key")
    slots: dict = {}
    val_arrs, val_kinds, agg_ops = [], [], []
    for a in agg_list:
        if a.fn not in DEVICE_AGG_FNS:
            raise NotImplementedError(
                f"aggregate {a.fn}() is not in the torch port's subset "
                f"(supported: {sorted(DEVICE_AGG_FNS)})")
        if a.column is None:
            agg_ops.append(("count", -1, False))
            continue
        if a.column not in slots:
            arr = data.get(a.column)
            if arr is None:
                frame._column_values(a.column)      # raises KeyError
            val_kinds.append(_require_kind(arr, a.column,
                                           "aggregated column"))
            slots[a.column] = len(val_arrs)
            val_arrs.append(arr)
        agg_ops.append((a.fn, slots[a.column], bool(a.ignore_nulls)))
    # the JAX package groups string keys on its host path, which answers
    # a frame with no valid row with float columns
    if n == 0 or (words and not bool(frame.mask.any())):
        return _empty_frame(names, frame.device)

    mask = frame.mask
    out = None
    if not any(fn in _DISTINCT_FNS for fn, _, _ in agg_ops):
        S = min(_DENSE_MAX, max(2 * n, 16))
        out = _dense_agg(key_arrs, key_kinds, val_arrs, val_kinds, agg_ops,
                         mask, S)
    if out is None:
        out = _sorted_agg(key_arrs, key_kinds, val_arrs, val_kinds, agg_ops,
                          mask)
    key_outs, agg_outs = out
    for i, w in words.items():
        key_outs[i] = strings.decode(key_outs[i], w)
    cols = dict(zip(keys, key_outs))
    for a, arr in zip(agg_list, agg_outs):
        cols[a.name] = arr
    return Frame(cols, device=frame.device)


def gather_rows(frame, take: torch.Tensor, host_idx=None):
    """Every column of ``frame`` at the row indices ``take`` (a device
    int64 tensor): device columns by ``index_select``, string columns on
    the host (one extra read of the indices unless ``host_idx`` is
    given)."""
    from ..frame.frame import Frame

    out = {}
    for name, arr in frame._data.items():
        if is_host_column(arr):
            if host_idx is None:
                host_idx = take.cpu().numpy()
            out[name] = np.asarray(arr, dtype=object)[host_idx]
        else:
            out[name] = arr.index_select(0, take)
    return Frame(out, device=frame.device)


def device_sort(frame, names, ascending, nulls_first):
    """``Frame.sort``: a stable sort over (invalid flag, per key: null
    flag, value), so ties keep row order as the JAX package's host lexsort
    does; nulls first ascending and last descending unless pinned. A
    string key sorts by its codes, ascending only (as in the JAX
    package). One host read (the valid-row count); payload gathered on
    the device."""
    mask = frame.mask
    keys, desc = [(~mask).to(torch.uint8)], [False]
    for name, asc, nf in zip(names, ascending, nulls_first):
        arr = frame._column_values(name)
        if is_host_column(arr):
            if not asc:
                raise ValueError("descending sort on string columns is "
                                 "not supported")
            (arr,), _ = strings.device_codes([arr], frame.device)
            null = arr == strings.NULL_CODE
            keys.append((~null if (asc if nf is None else nf) else null)
                        .to(torch.uint8))
            desc.append(False)
            keys.append(arr)
            desc.append(False)
            continue
        kind = _require_kind(arr, name, "sort key")
        if kind == "f":
            # flag False sorts first: nulls-first wants nulls = False
            null = torch.isnan(arr)
            nf = asc if nf is None else bool(nf)
            keys.append((~null if nf else null).to(torch.uint8))
            desc.append(False)
            arr = torch.where(null, torch.zeros_like(arr), arr)
        keys.append(_to_int8_if_bool(arr))
        desc.append(not asc)
    perm = _lex_perm(keys, frame.num_slots, frame.device, desc)
    nv = int(mask.sum())                        # THE host read
    return gather_rows(frame, perm[:nv])


def device_unique(frame, key_names):
    """``Frame.distinct`` (``key_names`` = every column) and
    ``drop_duplicates`` (a subset): the first valid row of each distinct
    key combination, in first-occurrence order. NaN keys fold into one
    null group; a 2-D column groups per component."""
    n = frame.num_slots
    key_arrs, key_kinds = [], []
    for k in key_names:
        arr = frame._column_values(k)
        if is_host_column(arr):
            comps = strings.device_codes([arr], frame.device)[0]
        elif arr.ndim == 2:
            comps = [arr[:, j] for j in range(arr.shape[1])]
        else:
            comps = [arr]
        for c in comps:
            key_kinds.append(_require_kind(c, k, "distinct key"))
            key_arrs.append(c)
    if n == 0:
        return frame._with()
    perm, valid, seg, boundary = _group_scaffold(key_arrs, key_kinds,
                                                 frame.mask)
    g = int(boundary.sum())                     # THE host read
    # a stable sort gives each group its smallest row index first; the
    # sorted first indices restore first-occurrence order
    orig_first = _seg_extreme(torch.where(valid, perm, n), seg, max(g, 1),
                              n, "amin")
    keep, _ = torch.sort(orig_first[:g])
    return gather_rows(frame, keep)
